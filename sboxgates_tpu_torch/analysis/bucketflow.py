"""R8 — bucket-discipline dataflow (shape provenance at dispatch sites).

Every operand shape entering a registered kernel must derive from a
declared bucket ladder (``bucket_size``/``PIVOT_G_BUCKETS``/
``FLEET_BUCKETS``/``STACKED_BUCKETS``, plus ``[tool.torchlint]
bucket_sources`` extras): the rendezvous merges only same-shaped
submissions into one lane-form launch (``search/warmup.warm_key`` keys
on operand shapes), so an operand padded to ``bucket - n`` shares its
merge key with every job in the bucket, while one shaped by a raw
``n``/``len(...)``/loop variable gets a key (and a caching-allocator
block size) per VALUE — lanes that never merge launch one by one.  The
per-file R1 sees only scalar-argument churn; this pass follows the
shape expressions themselves.

The analysis is intraprocedural by design: a dispatch site's operands
are either constructed in the dispatching function (checkable here) or
built by a shared operand builder whose own dispatch-facing shapes are
checked where THEY dispatch.  For each call of
``kernel_call``/``stream_dispatch``/``feasible_stream_dispatch`` in a
dispatch module, every array-constructor shape expression reachable
through local assignments is classified per axis:

* an axis mentioning a bucket source (directly, through local
  derivation, or via arithmetic like ``bucket - n`` — the padding
  idiom) is disciplined;
* an axis built ONLY from dynamic values (parameters, loop variables,
  locals of unknown provenance, data-dependent calls like ``len``) is
  a finding;
* constants and module-level names are static — one shape, no hazard.

Deliberately unbucketed shapes (a one-off probe, a host-only path) are
acknowledged with ``# torchlint: ignore[R8] reason``.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .callgraph import ProjectGraph, iter_body_nodes as _body_nodes
from .config import TorchlintConfig
from .rules import dotted

RawFinding = Tuple[str, int, int, str]

#: Dispatch entry points whose operands the pass follows.
_DISPATCH_TAILS = frozenset(
    {"kernel_call", "stream_dispatch", "feasible_stream_dispatch"}
)

#: Array constructors and the index/kwarg of their shape expression.
#: ``None`` index = every positional argument is an axis (reshape).
_SHAPE_CTORS: Dict[str, Tuple[Optional[int], Optional[str]]] = {
    "zeros": (0, "shape"),
    "ones": (0, "shape"),
    "empty": (0, "shape"),
    "full": (0, "shape"),
    "broadcast_to": (1, "shape"),
    "reshape": (None, None),
    "pad": (1, None),  # pad_width carries the bucket arithmetic
}

_ARRAY_HEADS = frozenset({"np", "numpy", "torch"})


def _tail(name: Optional[str]) -> str:
    return (name or "").rsplit(".", 1)[-1]


def _is_const_expr(expr: ast.AST) -> bool:
    """Built only from literals and operators — no names, calls, or
    attribute loads, so the value is the same every execution."""
    return not any(
        isinstance(n, (ast.Name, ast.Call, ast.Attribute))
        for n in ast.walk(expr)
    )


def _is_source_name(name: str, sources: Sequence[str]) -> bool:
    t = _tail(name)
    return t in sources or "bucket" in t.lower()


class _FuncShapes:
    """Shape-provenance scan of ONE function."""

    def __init__(self, fi, config: TorchlintConfig) -> None:
        self.fi = fi
        self.sources = list(config.bucket_sources)
        self.assigns: Dict[str, List[ast.AST]] = {}
        self.loop_vars: Set[str] = set()
        a = fi.node.args
        self.params: Set[str] = {
            p.arg
            for p in (
                a.posonlyargs + a.args + a.kwonlyargs
                + ([a.vararg] if a.vararg else [])
                + ([a.kwarg] if a.kwarg else [])
            )
        }
        self._index(fi.node)
        self.derived = self._derived_fixpoint()
        #: locals whose every assignment is a constant expression — one
        #: shape, no merge-key hazard (n = 128)
        self.const_locals: Set[str] = {
            name
            for name, exprs in self.assigns.items()
            if name not in self.loop_vars
            and all(_is_const_expr(e) for e in exprs)
        }

    def _index(self, fn: ast.AST) -> None:
        for node in _body_nodes(fn):
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = (
                    node.targets if isinstance(node, ast.Assign)
                    else [node.target]
                )
                if node.value is None:
                    continue
                for t in targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            self.assigns.setdefault(n.id, []).append(
                                node.value
                            )
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                for n in ast.walk(node.target):
                    if isinstance(n, ast.Name):
                        self.loop_vars.add(n.id)
            elif isinstance(node, ast.comprehension):
                for n in ast.walk(node.target):
                    if isinstance(n, ast.Name):
                        self.loop_vars.add(n.id)

    def _expr_mentions_derived(self, expr: ast.AST,
                               derived: Set[str]) -> bool:
        for n in ast.walk(expr):
            if isinstance(n, ast.Name):
                if n.id in derived or _is_source_name(n.id, self.sources):
                    return True
            elif isinstance(n, (ast.Attribute, ast.Call)):
                name = dotted(n if isinstance(n, ast.Attribute) else n.func)
                if name is not None and _is_source_name(name, self.sources):
                    return True
        return False

    def _derived_fixpoint(self) -> Set[str]:
        derived: Set[str] = set()
        for p in self.params:
            if _is_source_name(p, self.sources):
                derived.add(p)
        changed = True
        while changed:
            changed = False
            for name in sorted(self.assigns):
                if name in derived:
                    continue
                if any(
                    self._expr_mentions_derived(e, derived)
                    for e in self.assigns[name]
                ):
                    derived.add(name)
                    changed = True
        return derived

    # -- axis classification ----------------------------------------------

    def axis_offenders(self, expr: ast.AST) -> Tuple[bool, List[str]]:
        """(mentions a bucket derivation, dynamic offender names)."""
        has_derived = False
        offenders: List[str] = []

        def walk(n: ast.AST) -> None:
            nonlocal has_derived
            if isinstance(n, ast.Name):
                if n.id in self.derived or _is_source_name(
                    n.id, self.sources
                ):
                    has_derived = True
                elif n.id in self.loop_vars:
                    offenders.append(f"loop variable '{n.id}'")
                elif n.id in self.params:
                    offenders.append(f"parameter '{n.id}'")
                elif n.id in self.const_locals:
                    pass  # constant-assigned local: static, quiet
                elif n.id in self.assigns:
                    offenders.append(f"'{n.id}'")
                # else: module constant / import — static, quiet
                return
            if isinstance(n, ast.Attribute):
                name = dotted(n)
                if name is not None and _is_source_name(name, self.sources):
                    has_derived = True
                # other attributes (x.shape, CONST.width) stay quiet
                return
            if isinstance(n, ast.Call):
                fname = dotted(n.func)
                if fname is not None and _is_source_name(
                    fname, self.sources
                ):
                    has_derived = True
                    return
                for a in list(n.args) + [
                    kw.value for kw in n.keywords
                ]:
                    walk(a)
                offenders.append(f"'{_tail(fname) or '<call>'}()'")
                return
            for child in ast.iter_child_nodes(n):
                walk(child)

        walk(expr)
        return has_derived, offenders


def _shape_exprs(call: ast.Call) -> List[ast.AST]:
    """The shape expression(s) of an array-constructor call, if it is
    one."""
    fname = dotted(call.func)
    t = _tail(fname)
    if t not in _SHAPE_CTORS:
        return []
    if t == "reshape":
        if not isinstance(call.func, ast.Attribute):
            return []
        head = (fname or "").split(".", 1)[0]
        if head in _ARRAY_HEADS:
            # free function np.reshape(arr, newshape): the array operand
            # is not an axis
            return list(call.args[1:])
        return list(call.args)  # method form x.reshape(a, b, ...)
    # np/torch free functions only (a project helper named `zeros` is not
    # an array constructor we can reason about)
    head = (fname or "").split(".", 1)[0]
    if head not in _ARRAY_HEADS:
        return []
    idx, kwname = _SHAPE_CTORS[t]
    out: List[ast.AST] = []
    if idx is not None and len(call.args) > idx:
        out.append(call.args[idx])
    if kwname is not None:
        out.extend(
            kw.value for kw in call.keywords if kw.arg == kwname
        )
    return out


def run_r8(graph: ProjectGraph,
           config: TorchlintConfig) -> Dict[str, List[RawFinding]]:
    out: Dict[str, List[RawFinding]] = {}
    for fkey in sorted(graph.functions):
        fi = graph.functions[fkey]
        if not config.is_dispatch(fi.path):
            continue
        scan: Optional[_FuncShapes] = None
        for node in _body_nodes(fi.node):
            if not isinstance(node, ast.Call):
                continue
            if _tail(dotted(node.func)) not in _DISPATCH_TAILS:
                continue
            if scan is None:
                scan = _FuncShapes(fi, config)
            kernel = "?"
            if node.args and isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str):
                kernel = node.args[0].value
            seen_ctors: Set[int] = set()
            arg_exprs = list(node.args) + [
                kw.value for kw in node.keywords
            ]
            for arg in arg_exprs:
                for ctor, shape in _operand_shapes(arg, scan):
                    if id(ctor) in seen_ctors:
                        continue
                    seen_ctors.add(id(ctor))
                    _check_shape(
                        out, fi.path, kernel, ctor, shape, scan
                    )
    return out


def _operand_shapes(arg: ast.AST, scan: _FuncShapes):
    """(constructor call, shape expr) pairs reachable from one operand
    expression: constructors inline in the expression, plus those in
    the local assignments of every name it mentions (transitively)."""
    exprs: List[ast.AST] = [arg]
    visited: Set[str] = set()
    frontier = [
        n.id for n in ast.walk(arg) if isinstance(n, ast.Name)
    ]
    while frontier:
        name = frontier.pop()
        if name in visited:
            continue
        visited.add(name)
        for e in scan.assigns.get(name, ()):
            exprs.append(e)
            frontier.extend(
                n.id for n in ast.walk(e) if isinstance(n, ast.Name)
            )
    for e in exprs:
        for n in ast.walk(e):
            if isinstance(n, ast.Call):
                for shape in _shape_exprs(n):
                    yield n, shape


def _check_shape(out, path: str, kernel: str, ctor: ast.Call,
                 shape: ast.AST, scan: _FuncShapes) -> None:
    axes = (
        shape.elts
        if isinstance(shape, (ast.Tuple, ast.List))
        else [shape]
    )
    bad: List[str] = []
    for axis in axes:
        has_derived, offenders = scan.axis_offenders(axis)
        if offenders and not has_derived:
            bad.extend(offenders)
    if not bad:
        return
    uniq = sorted(set(bad))
    out.setdefault(path, []).append(
        (
            "R8",
            ctor.lineno,
            ctor.col_offset,
            f"operand shape for dispatch of '{kernel}' derives from "
            f"non-bucketed value(s) {', '.join(uniq)}: every distinct "
            "value is a merge key of its own (its lanes never stack into "
            "one launch) — pad to a declared "
            "bucket ladder (bucket_size/PIVOT_G_BUCKETS/FLEET_BUCKETS/"
            "STACKED_BUCKETS) or acknowledge with ignore[R8] and a "
            "reason",
        )
    )
