"""R14: admission-order discipline (whole-program pass).

The front door's robustness spine is an ORDER: authenticate and
rate-limit before anything else, quota before any fresh-admission
effect, the fsync'd admission-journal append before the orchestrator
enqueue and before the client's 202.  The runtime tests pin that order
by injecting faults between the steps; this pass pins it structurally:

* every **effectful call** (``effect_sites``: orchestrator
  enqueue/join, durable admission records) in a ``handler_modules``
  function must be *dominated* by an auth/rate site (``auth_sites``)
  AND a quota site (``quota_sites``) — the check ran on every path to
  the effect, not merely on some path;
* every **2xx admission response** (a ``response_sites`` call with a
  constant 201/202 status argument) must be dominated by a journal
  append (``journal_sites``) — a crash after an unjournaled 202 loses
  a job the client was told is admitted.

Dominance is computed by a lexical walk over the handler body (the R10
branch machinery): a site inside one arm of an ``if`` does not
dominate the code after it, a site in the test does, a terminating arm
passes the other arm's state through, a loop body dominates nothing
after the loop (zero iterations).  A check hoisted into a shared
helper still counts: the R10 transitive-reach witness machinery marks
every function that reaches a declared site, so ``self._auth(h)``
establishes auth because ``_auth`` reaches ``authenticate``.  Helpers
called only from dominated positions inherit their callers' state (a
bounded interprocedural entry-state fixpoint over the call graph), so
``_store_sbox`` — called only after auth+quota in ``_post_job`` — is
not re-flagged.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .callgraph import ProjectGraph, iter_body_nodes
from .config import TorchlintConfig
from .trustflow import site_name

RawFinding = Tuple[str, int, int, str]

#: Dominance flag classes.
_AUTH, _QUOTA, _JOURNAL = "auth", "quota", "journal"


def _reach_maps(graph: ProjectGraph, config: TorchlintConfig
                ) -> Dict[str, Dict[str, str]]:
    """flag class -> {function key -> witness} for every function that
    (transitively) issues a call matching that class's sites — the R10
    reach machinery, seeded for all three classes in ONE body scan."""
    site_lists = {
        _AUTH: config.auth_sites,
        _QUOTA: config.quota_sites,
        _JOURNAL: config.journal_sites,
    }
    seeds: Dict[str, Dict[str, str]] = {f: {} for f in site_lists}
    for fkey in sorted(graph.functions):
        fi = graph.functions[fkey]
        for node in iter_body_nodes(fi.node):
            if not isinstance(node, ast.Call):
                continue
            for flag, sites in site_lists.items():
                entry = site_name(node, sites)
                if entry is not None:
                    w = f"{entry} (via {fi.path}:{node.lineno})"
                    cur = seeds[flag].get(fkey)
                    if cur is None or w < cur:
                        seeds[flag][fkey] = w
    return {
        flag: graph.reach_witness(seeds[flag]) for flag in site_lists
    }


def _const_status(node: ast.Call) -> Optional[int]:
    """The first constant-int argument of a response call (the status
    code position), or None when the status is not a literal."""
    for arg in list(node.args) + [kw.value for kw in node.keywords]:
        if isinstance(arg, ast.Constant) and isinstance(arg.value, int):
            return int(arg.value)
    return None


class _FuncOrder:
    """One dominance walk over one handler function."""

    def __init__(self, graph: ProjectGraph, fkey: str,
                 config: TorchlintConfig,
                 reach: Dict[str, Dict[str, str]],
                 entry_flags: Set[str]) -> None:
        self.fi = graph.functions[fkey]
        self.config = config
        self.reach = reach
        self.calls = graph.call_index(fkey)
        self.entry_flags = set(entry_flags)
        self.findings: List[RawFinding] = []
        #: callee key -> intersection of flags held at its call sites
        #: (the entry-state propagation the fixpoint consumes).
        self.callsite_flags: Dict[str, Set[str]] = {}
        #: flag -> first establishment witness anywhere in the body
        #: (names the undominated path in the finding message).
        self.flag_sites: Dict[str, str] = {}

    # -- event classification ---------------------------------------------

    def _establishes(self, node: ast.Call) -> Set[str]:
        """Flag classes this call establishes, directly or because a
        resolved callee transitively reaches a declared site."""
        got: Set[str] = set()
        for flag, sites in (
            (_AUTH, self.config.auth_sites),
            (_QUOTA, self.config.quota_sites),
            (_JOURNAL, self.config.journal_sites),
        ):
            entry = site_name(node, sites)
            witness = f"{entry} at line {node.lineno}" if entry else None
            if witness is None:
                for callee in self.calls.get(
                    (node.lineno, node.col_offset), ()
                ):
                    w = self.reach[flag].get(callee)
                    if w is not None:
                        witness = w
                        break
            if witness is not None:
                got.add(flag)
                self.flag_sites.setdefault(flag, witness)
        return got

    def _calls_in(self, node: ast.AST) -> List[ast.Call]:
        """Call nodes evaluated when this statement/expression runs —
        nested defs and lambdas excluded (they run later, elsewhere)."""
        out: List[ast.Call] = []
        stack: List[ast.AST] = [node]
        while stack:
            n = stack.pop()
            if isinstance(
                n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                    ast.ClassDef)
            ):
                continue
            if isinstance(n, ast.Call):
                out.append(n)
            stack.extend(ast.iter_child_nodes(n))
        out.sort(key=lambda c: (c.lineno, c.col_offset))
        return out

    def _events(self, node: ast.AST, flags: Set[str]) -> Set[str]:
        """Process every call evaluated by this statement: record
        callee entry states (pre-statement flags), establish new flags,
        then judge effect/response calls against the establisher-
        augmented flag set (an append-and-ack one-liner is in order)."""
        calls = self._calls_in(node)
        pre = set(flags)
        established: Set[str] = set()
        for c in calls:
            for callee in self.calls.get((c.lineno, c.col_offset), ()):
                cur = self.callsite_flags.get(callee)
                if cur is None:
                    self.callsite_flags[callee] = set(pre)
                else:
                    cur &= pre
            established |= self._establishes(c)
        held = flags | established
        for c in calls:
            self._judge(c, held)
        return established

    def _judge(self, node: ast.Call, flags: Set[str]) -> None:
        effect = site_name(node, self.config.effect_sites)
        if effect is not None:
            missing = [f for f in (_AUTH, _QUOTA) if f not in flags]
            if missing:
                hints = [
                    f"{self.flag_sites[f]} runs on another path"
                    if f in self.flag_sites
                    else f"no {f} site on any path"
                    for f in missing
                ]
                self.findings.append(
                    (
                        "R14",
                        node.lineno,
                        node.col_offset,
                        f"effectful call {effect} is not dominated by "
                        f"the {'/'.join(missing)} check site(s) "
                        f"({'; '.join(hints)}) — admission order is "
                        "auth -> quota -> fsync'd journal -> effect "
                        "(the front door's contract); hoist the check or "
                        "acknowledge with ignore[R14] and a reason",
                    )
                )
        resp = site_name(node, self.config.response_sites)
        if resp is not None:
            status = _const_status(node)
            if status in (201, 202) and _JOURNAL not in flags:
                hint = (
                    f"{self.flag_sites[_JOURNAL]} runs on another path"
                    if _JOURNAL in self.flag_sites
                    else "no journal append on any path"
                )
                self.findings.append(
                    (
                        "R14",
                        node.lineno,
                        node.col_offset,
                        f"{status} admission response ({resp}) is not "
                        "dominated by the fsync'd admission-journal "
                        f"append ({hint}) — a crash after this "
                        "response loses a job the client was told is "
                        "admitted; append first or acknowledge with "
                        "ignore[R14] and a reason",
                    )
                )

    # -- the dominance walk -------------------------------------------------

    def run(self) -> None:
        self._scan(list(getattr(self.fi.node, "body", ())),
                   set(self.entry_flags))

    def _scan(self, stmts: List[ast.stmt],
              flags: Set[str]) -> Optional[Set[str]]:
        """Walk one block; returns the exit flag set, or None when the
        block unconditionally leaves the enclosing scope."""
        flags = set(flags)
        for st in stmts:
            if isinstance(
                st, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                continue
            if isinstance(st, ast.If):
                flags |= self._events(st.test, flags)
                body_exit = self._scan(st.body, flags)
                else_exit = self._scan(st.orelse, flags)
                if body_exit is None and else_exit is None:
                    return None
                if body_exit is None:
                    flags = else_exit
                elif else_exit is None:
                    flags = body_exit
                else:
                    flags = body_exit & else_exit
            elif isinstance(st, ast.Try):
                body_exit = self._scan(st.body, flags)
                exits = []
                if body_exit is not None:
                    if st.orelse:
                        body_exit = self._scan(st.orelse, body_exit)
                    if body_exit is not None:
                        exits.append(body_exit)
                for h in st.handlers:
                    # a handler may catch BEFORE any body flag landed
                    h_exit = self._scan(h.body, flags)
                    if h_exit is not None:
                        exits.append(h_exit)
                after = (
                    set.intersection(*exits) if exits else None
                )
                if st.finalbody:
                    fin = self._scan(
                        st.finalbody,
                        after if after is not None else flags,
                    )
                    if fin is None or after is None:
                        return None
                    flags = fin
                else:
                    if after is None:
                        return None
                    flags = after
            elif isinstance(st, (ast.For, ast.AsyncFor)):
                flags |= self._events(st.iter, flags)
                self._scan(st.body, flags)  # may run zero times
                self._scan(st.orelse, flags)
            elif isinstance(st, ast.While):
                flags |= self._events(st.test, flags)
                self._scan(st.body, flags)  # may run zero times
                self._scan(st.orelse, flags)
            elif isinstance(st, (ast.With, ast.AsyncWith)):
                for item in st.items:
                    flags |= self._events(item.context_expr, flags)
                body_exit = self._scan(st.body, flags)
                if body_exit is None:
                    return None
                flags = body_exit
            else:
                flags |= self._events(st, flags)
                if isinstance(
                    st, (ast.Return, ast.Raise, ast.Continue, ast.Break)
                ):
                    return None
        return flags


def run_r14(graph: ProjectGraph,
            config: TorchlintConfig) -> Dict[str, List[RawFinding]]:
    """R14 findings per project-relative path."""
    handler_fns = [
        fkey
        for fkey in sorted(graph.functions)
        if config.is_handler(graph.functions[fkey].path)
    ]
    if not handler_fns:
        return {}
    reach = _reach_maps(graph, config)
    callers: Dict[str, Set[str]] = {}
    for e in graph.edges:
        callers.setdefault(e.callee, set()).add(e.caller)
    walked = set(handler_fns)
    entry: Dict[str, Set[str]] = {f: set() for f in handler_fns}
    for _ in range(12):  # bounded entry-state fixpoint (monotone)
        callsite: Dict[str, Set[str]] = {}
        for fkey in handler_fns:
            scan = _FuncOrder(graph, fkey, config, reach, entry[fkey])
            scan.run()
            for callee, fl in scan.callsite_flags.items():
                if callee in callsite:
                    callsite[callee] &= fl
                else:
                    callsite[callee] = set(fl)
        changed = False
        for fkey in handler_fns:
            cs = callers.get(fkey, set())
            # entry state is inherited only when EVERY caller is a
            # walked handler function whose call sites we observed —
            # an entry point (or a function reachable from outside the
            # handler tier) keeps the empty entry state.
            if cs and cs <= walked and fkey in callsite:
                new = callsite[fkey]
                if new != entry[fkey]:
                    entry[fkey] = new
                    changed = True
        if not changed:
            break

    out: Dict[str, List[RawFinding]] = {}
    for fkey in handler_fns:
        scan = _FuncOrder(graph, fkey, config, reach, entry[fkey])
        scan.run()
        if scan.findings:
            out.setdefault(scan.fi.path, []).extend(scan.findings)
    return out
