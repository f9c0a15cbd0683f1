"""R15: resource lifecycle (whole-program pass).

The drain contract is a lifecycle fact: the listener socket is
closed before the orchestrator drains, the accept thread is joined,
and a failed bind never leaks an ephemeral listener.  The runtime
tests exercise the happy path; this pass makes the discipline a static
fact for every ``resource_ctors`` acquisition (sockets, listener
servers, threads, temp files) in the project:

* an acquisition bound to a local must be released on ALL exit paths —
  a ``with`` item, a release call (``close``/``shutdown``/``join``/…)
  on it inside a ``finally`` block, ownership transfer (returned, or
  passed as an argument to another call), or registration in a
  declared teardown registry (``teardown_registries``: the CLI's
  ``drain_hooks``, ``_teardown``, ``atexit.register``).  A straight-
  line ``close()`` with no ``finally`` does NOT count: the statement
  between acquire and close that raises is exactly the leaked-listener
  bug;
* an acquisition stored on ``self`` transfers ownership to the
  instance — accepted only when some method of the class actually
  releases that attribute (directly, through a local/loop variable
  derived from it, or by handing it to a teardown registry);
* an acquisition that is constructed and discarded
  (``Thread(...).start()``) can never be released by anyone — flagged
  at the constructor.

Daemon threads (``Thread(..., daemon=True)``) are exempt: their
lifecycle is the process's, by declaration.  A project class derived
from a declared constructor (``class Server(ThreadingHTTPServer)``)
is itself a resource constructor.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .callgraph import ProjectGraph, iter_body_nodes
from .config import TorchlintConfig
from .rules import dotted
from .trustflow import site_name

RawFinding = Tuple[str, int, int, str]

#: Method tails that release/retire a resource.
_RELEASE_TAILS = frozenset(
    {
        "close", "shutdown", "server_close", "stop", "join", "cancel",
        "terminate", "release", "unlink", "remove", "cleanup", "kill",
    }
)


def _is_daemon_ctor(node: ast.Call) -> bool:
    for kw in node.keywords:
        if (
            kw.arg == "daemon"
            and isinstance(kw.value, ast.Constant)
            and kw.value.value is True
        ):
            return True
    return False


def _registry_call(node: ast.Call, registries: List[str]) -> bool:
    """Is this call a teardown-registry registration?  A bare entry
    ("drain_hooks") matches anywhere in the dotted chain (the
    ``drain_hooks.append(...)`` receiver); a dotted entry
    ("atexit.register") uses the declared-site semantics."""
    name = dotted(node.func)
    if name is None:
        return False
    parts = name.split(".")
    for entry in registries:
        if "." in entry:
            ehead, _, etail = entry.rpartition(".")
            if parts[-1] == etail and ehead in parts[:-1]:
                return True
        elif entry in parts:
            return True
    return False


def _mentions_name(expr: ast.AST, var: str) -> bool:
    return any(
        isinstance(n, ast.Name) and n.id == var
        for n in ast.walk(expr)
    )


def _mentions_attr(expr: ast.AST, attr: str) -> bool:
    return any(
        isinstance(n, ast.Attribute) and n.attr == attr
        for n in ast.walk(expr)
    )


def _release_of_var(node: ast.Call, var: str) -> bool:
    """``var.close()`` (receiver) or ``os.close(var)`` (argument of a
    release-tail call)."""
    name = dotted(node.func)
    if name is None:
        return False
    parts = name.split(".")
    if parts[-1] not in _RELEASE_TAILS:
        return False
    if var in parts[:-1]:
        return True
    return any(
        _mentions_name(a, var)
        for a in list(node.args) + [kw.value for kw in node.keywords]
    )


def derived_ctors(graph: ProjectGraph,
                  config: TorchlintConfig) -> List[str]:
    """resource_ctors plus every project class (transitively) derived
    from one — ``class Server(ThreadingHTTPServer)`` is a listener
    constructor too."""
    ctor_tails = {e.rsplit(".", 1)[-1] for e in config.resource_ctors}
    bases: Dict[str, Set[str]] = {}
    for mname in sorted(graph.modules):
        tree = graph.modules[mname].tree
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                tails = set()
                for b in node.bases:
                    d = dotted(b)
                    if d is not None:
                        tails.add(d.rsplit(".", 1)[-1])
                bases.setdefault(node.name, set()).update(tails)
    derived: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for cname in sorted(bases):
            if cname in derived:
                continue
            if bases[cname] & (ctor_tails | derived):
                derived.add(cname)
                changed = True
    return list(config.resource_ctors) + sorted(derived)


class _Acquisition:
    def __init__(self, node: ast.Call, entry: str) -> None:
        self.node = node
        self.entry = entry
        self.names: Set[str] = set()  # locals bound to the resource
        self.self_attrs: Set[str] = set()  # self attrs bound directly


def _class_releases(graph: ProjectGraph, module: str, cls: str,
                    attr: str, registries: List[str]) -> bool:
    """Does any method of (module, cls) release ``self.<attr>`` —
    directly, via a local derived from it, or by registering it in a
    teardown registry?"""
    for fkey in sorted(graph.functions):
        fi = graph.functions[fkey]
        if fi.module != module or fi.cls != cls:
            continue
        derived: Set[str] = set()
        for node in iter_body_nodes(fi.node):
            if isinstance(node, ast.Assign):
                if _mentions_attr(node.value, attr):
                    for t in node.targets:
                        for n in ast.walk(t):
                            if isinstance(n, ast.Name):
                                derived.add(n.id)
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                if _mentions_attr(node.iter, attr):
                    for n in ast.walk(node.target):
                        if isinstance(n, ast.Name):
                            derived.add(n.id)
        for node in iter_body_nodes(fi.node):
            if not isinstance(node, ast.Call):
                continue
            name = dotted(node.func)
            if name is not None:
                parts = name.split(".")
                if parts[-1] in _RELEASE_TAILS and (
                    attr in parts[:-1]
                    or (set(parts[:-1]) & derived)
                ):
                    return True
            if _registry_call(node, registries):
                # ast.walk descends into lambda bodies, so a
                # `registry.append(lambda: self.x.close())` counts.
                for a in (
                    list(node.args)
                    + [kw.value for kw in node.keywords]
                ):
                    if _mentions_attr(a, attr):
                        return True
    return False


class _FuncLife:
    """R15 scan of one function body."""

    def __init__(self, graph: ProjectGraph, fkey: str,
                 config: TorchlintConfig, ctors: List[str]) -> None:
        self.graph = graph
        self.fi = graph.functions[fkey]
        self.config = config
        self.ctors = ctors

    def _ctor_calls(self) -> List[Tuple[ast.Call, str]]:
        out = []
        for node in iter_body_nodes(self.fi.node):
            if isinstance(node, ast.Call):
                entry = site_name(node, self.ctors)
                if entry is not None and not _is_daemon_ctor(node):
                    out.append((node, entry))
        out.sort(key=lambda p: (p[0].lineno, p[0].col_offset))
        return out

    def findings(self) -> List[RawFinding]:
        ctor_calls = self._ctor_calls()
        if not ctor_calls:
            return []
        fn = self.fi.node
        with_ids: Set[int] = set()
        arg_ids: Set[int] = set()
        return_ids: Set[int] = set()
        acquisitions: Dict[int, _Acquisition] = {}
        ctor_ids = {id(c) for c, _ in ctor_calls}

        for node in iter_body_nodes(fn):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    for n in ast.walk(item.context_expr):
                        with_ids.add(id(n))
            elif isinstance(node, ast.Call):
                for a in (
                    list(node.args)
                    + [kw.value for kw in node.keywords]
                ):
                    for n in ast.walk(a):
                        if id(n) in ctor_ids:
                            arg_ids.add(id(n))
            elif isinstance(node, ast.Return) and node.value is not None:
                for n in ast.walk(node.value):
                    if id(n) in ctor_ids:
                        return_ids.add(id(n))
            elif isinstance(node, (ast.Assign, ast.AnnAssign,
                                   ast.NamedExpr)):
                value = node.value
                if value is None:
                    continue
                held = [
                    n for n in ast.walk(value) if id(n) in ctor_ids
                ]
                if not held:
                    continue
                targets = (
                    node.targets
                    if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for c in held:
                    acq = acquisitions.setdefault(
                        id(c),
                        _Acquisition(
                            c,
                            next(e for cc, e in ctor_calls if cc is c),
                        ),
                    )
                    for t in targets:
                        if isinstance(t, ast.Name):
                            acq.names.add(t.id)
                        elif isinstance(t, ast.Tuple):
                            for el in t.elts:
                                if isinstance(el, ast.Name):
                                    acq.names.add(el.id)
                        elif (
                            isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"
                        ):
                            acq.self_attrs.add(t.attr)

        out: List[RawFinding] = []
        for call, entry in ctor_calls:
            if id(call) in with_ids or id(call) in arg_ids:
                continue  # with-managed, or ownership handed to a call
            if id(call) in return_ids:
                continue  # ownership transfer to the caller
            acq = acquisitions.get(id(call))
            if acq is None:
                out.append(
                    (
                        "R15",
                        call.lineno,
                        call.col_offset,
                        f"resource {entry} is constructed and "
                        "discarded — nothing can ever release it; "
                        "bind it to an owner with a teardown path or "
                        "acknowledge with ignore[R15] and a reason",
                    )
                )
                continue
            reason = self._unreleased(acq)
            if reason is not None:
                out.append(
                    (
                        "R15",
                        call.lineno,
                        call.col_offset,
                        f"resource {entry} is not released on all "
                        f"exit paths ({reason}) — close it in a "
                        "finally/with, return it, register it in a "
                        "teardown registry "
                        f"({', '.join(self.config.teardown_registries)})"
                        ", or store it on an owner with a teardown "
                        "method; or acknowledge with ignore[R15] and "
                        "a reason",
                    )
                )
        return out

    def _aliases(self, names: Set[str]) -> Set[str]:
        """``names`` plus locals derived from them: assignment targets
        whose RHS mentions one, loop variables iterating over one."""
        fn = self.fi.node
        out = set(names)
        changed = bool(out)
        while changed:
            changed = False
            for node in iter_body_nodes(fn):
                src: Optional[ast.AST] = None
                tgt_names: Set[str] = set()
                if isinstance(node, ast.Assign):
                    src = node.value
                    for t in node.targets:
                        for n in ast.walk(t):
                            if isinstance(n, ast.Name):
                                tgt_names.add(n.id)
                elif isinstance(node, (ast.For, ast.AsyncFor)):
                    src = node.iter
                    for n in ast.walk(node.target):
                        if isinstance(n, ast.Name):
                            tgt_names.add(n.id)
                if src is None or tgt_names <= out:
                    continue
                if any(_mentions_name(src, v) for v in out):
                    out |= tgt_names
                    changed = True
        return out

    def _unreleased(self, acq: _Acquisition) -> Optional[str]:
        """None when the acquisition is safely released; otherwise a
        short reason naming what is missing."""
        fn = self.fi.node
        # Aliases (loop vars over a thread list, re-bound handles) are
        # honored for RELEASE sites only; ownership-transfer rules use
        # the directly-bound names, so a derived scalar passed to an
        # unrelated call does not launder the resource.
        aliases = self._aliases(acq.names)
        for var in sorted(aliases):
            for node in iter_body_nodes(fn):
                if isinstance(node, ast.Try):
                    # release inside finally covers every exit path
                    for st in node.finalbody:
                        for n in ast.walk(st):
                            if isinstance(n, ast.Call) and (
                                _release_of_var(n, var)
                            ):
                                return None
                elif isinstance(node, (ast.With, ast.AsyncWith)):
                    # `with s:` releases on all paths by construction
                    for item in node.items:
                        if _mentions_name(item.context_expr, var):
                            return None
                elif isinstance(node, ast.Call) and _registry_call(
                    node, self.config.teardown_registries
                ):
                    args = (
                        list(node.args)
                        + [kw.value for kw in node.keywords]
                    )
                    if any(_mentions_name(a, var) for a in args):
                        return None
        for var in sorted(acq.names):
            # ownership transfers
            for node in iter_body_nodes(fn):
                if isinstance(node, ast.Return) and node.value is not None:
                    if _mentions_name(node.value, var):
                        return None
                elif isinstance(node, ast.Call):
                    if _registry_call(
                        node, self.config.teardown_registries
                    ):
                        continue  # judged above, for every alias
                    args = (
                        list(node.args)
                        + [kw.value for kw in node.keywords]
                    )
                    # handed to another owner
                    if any(_mentions_name(a, var) for a in args):
                        return None
                elif isinstance(node, ast.Assign):
                    # re-binding to an attribute transfers ownership;
                    # self attrs additionally require a class teardown
                    for t in node.targets:
                        tgt = t
                        if isinstance(tgt, ast.Subscript):
                            tgt = tgt.value
                        if isinstance(
                            tgt, ast.Attribute
                        ) and _mentions_name(node.value, var):
                            if (
                                isinstance(tgt.value, ast.Name)
                                and tgt.value.id == "self"
                            ):
                                acq.self_attrs.add(tgt.attr)
                            else:
                                return None
        for attr in sorted(acq.self_attrs):
            if self.fi.cls is not None and _class_releases(
                self.graph, self.fi.module, self.fi.cls, attr,
                self.config.teardown_registries,
            ):
                return None
            return (
                f"stored on self.{attr} but no method of "
                f"{self.fi.cls or 'its class'} releases it"
            )
        if acq.names:
            names = "/".join(sorted(acq.names))
            return (
                f"'{names}' has no finally-guarded release, return, "
                "or registry hand-off"
            )
        return "no release path found"


def run_r15(graph: ProjectGraph,
            config: TorchlintConfig) -> Dict[str, List[RawFinding]]:
    """R15 findings per project-relative path."""
    ctors = derived_ctors(graph, config)
    out: Dict[str, List[RawFinding]] = {}
    for fkey in sorted(graph.functions):
        scan = _FuncLife(graph, fkey, config, ctors)
        found = scan.findings()
        if found:
            out.setdefault(scan.fi.path, []).extend(found)
    return out
