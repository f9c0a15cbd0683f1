"""Project symbol table and cross-module call graph for torchlint.

The per-file rules (R1–R5) are structurally blind to anything that
crosses a module boundary: a lock imported from a sibling module, a
thread target that reaches shared state three calls deep, a compiled
function fed loop-varying Python scalars from another file.  This module
builds the whole-program substrate the ``x``-rules run on:

* a **module index** per file — import aliases, module-level locks and
  mutable state, every function/method (any nesting level), classes,
  and ``global``-rebound names;
* a **project symbol resolver** that chases import/alias/re-export
  chains to the defining module;
* a **call graph** whose edges carry the call site, the enclosing
  ``with``-lock stack, loop context, and the raw ``ast.Call`` (for
  static-arg inspection), with name-based fallback resolution for
  attribute calls (``self.stream.next_chunk(...)`` resolves to every
  project method named ``next_chunk``);
* **thread-entry roots** (``threading.Thread(target=...)`` anywhere,
  plus ``[tool.torchlint] thread_roots`` extras) and **compile-boundary
  roots** (``jit_roots``: functions compiled by a ``torch.compile`` /
  ``torch.jit`` decorator or wrapped at module scope, plus ``jit_roots``
  extras);
* a **lock-parameter fixpoint** so ``with lock:`` counts as held when
  the lock arrives as an argument, and **unlocked reachability** from
  the thread roots with path reconstruction for the findings.

Everything is deterministic: module/function iteration is sorted, BFS
uses sorted adjacency, and name-based candidates are sorted, so two
runs over the same tree produce byte-identical output.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .rules import (
    _LOCK_CTORS,
    _MUTABLE_CTORS,
    _MUTATORS,
    _compile_call_of,
    classify_sync,
    compile_mode,
    dotted,
    function_compile_mode,
    scalar_loop_targets,
)

#: Attribute-call method names never resolved by bare name: they collide
#: with builtin container / file / threading APIs, and a false edge from
#: ``d.get(...)`` into a project method named ``get`` would make half the
#: package spuriously thread-reachable.  Skipping only costs edges
#: (false negatives), never false findings.
_COMMON_METHOD_NAMES = frozenset(
    {
        "append", "extend", "insert", "add", "update", "remove", "discard",
        "pop", "popitem", "popleft", "appendleft", "clear", "setdefault",
        "get", "put", "set", "is_set", "wait", "notify", "notify_all",
        "join", "start", "acquire", "release", "items", "keys", "values",
        "close", "open", "read", "write", "flush", "seek", "copy", "sort",
        "split", "strip", "format", "encode", "decode", "count", "index",
        "result", "done", "cancel", "submit", "mkdir", "exists", "lower",
        "upper", "startswith", "endswith", "replace", "tolist", "item",
        "astype", "reshape", "sum", "any", "all", "min", "max", "mean",
    }
)

_THREAD_CTORS = {"threading.Thread", "Thread"}


def iter_body_nodes(fn_node: ast.AST):
    """Every AST node in a function's own BODY — decorators and nested
    defs/lambdas excluded (decorators are definition-time; nested defs
    are their own graph entries).  Shared by the R7/R8 contract passes."""
    stack = list(getattr(fn_node, "body", ()))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def strip_locals(qualname: str) -> str:
    """``outer.<locals>.inner`` -> ``outer.inner`` — the form config
    root specs are written in (nobody types ``<locals>`` in a config)."""
    return qualname.replace(".<locals>", "")


def spec_matches_function(spec: str, key: str) -> bool:
    """Does a config root spec ("Qual.Name" or "pkg.mod:Qual.Name")
    name this function key?  ``<locals>`` segments in the key are
    transparent."""
    mod, qual = key.split(":", 1)
    quals = (qual, strip_locals(qual))
    if ":" in spec:
        smod, squal = spec.split(":", 1)
        return smod == mod and squal in quals
    return spec in quals


def _locally_bound_names(fn: ast.AST) -> Set[str]:
    """Names bound in ``fn``'s own scope: parameters plus assignment /
    loop / with-as / except-as / comprehension targets.  Nested def and
    lambda subtrees are skipped — their bindings live in THEIR scopes."""
    a = fn.args
    out: Set[str] = {
        p.arg
        for p in (
            a.posonlyargs + a.args + a.kwonlyargs
            + ([a.vararg] if a.vararg else [])
            + ([a.kwarg] if a.kwarg else [])
        )
    }

    def add_target(t: ast.AST) -> None:
        for n in ast.walk(t):
            if isinstance(n, ast.Name):
                out.add(n.id)

    def walk(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    out.add(child.name)
                continue
            if isinstance(child, (ast.Assign, ast.AugAssign,
                                  ast.AnnAssign)):
                targets = (
                    child.targets
                    if isinstance(child, ast.Assign)
                    else [child.target]
                )
                for t in targets:
                    # Name and tuple/list/starred unpacking targets bind
                    # locals; Attribute/Subscript stores bind nothing
                    # (and walking them would wrongly collect the base
                    # object's name).
                    if isinstance(t, (ast.Name, ast.Tuple, ast.List,
                                      ast.Starred)):
                        add_target(t)
            elif isinstance(child, (ast.For, ast.AsyncFor)):
                add_target(child.target)
            elif isinstance(child, (ast.With, ast.AsyncWith)):
                for item in child.items:
                    if item.optional_vars is not None:
                        add_target(item.optional_vars)
            elif isinstance(child, ast.ExceptHandler):
                if child.name:
                    out.add(child.name)
            elif isinstance(child, ast.comprehension):
                add_target(child.target)
            elif isinstance(child, ast.NamedExpr):
                add_target(child.target)
            walk(child)

    walk(fn)
    return out


def bind_call_args(callee: "FunctionInfo", call: ast.Call):
    """(param name, argument expr) pairs for a call of ``callee``,
    skipping the implicit ``self`` of bound-method calls.  ONE binder
    for the lock-parameter fixpoint and R1x — drift here would check
    the wrong parameter."""
    params = callee.params
    skip_self = 1 if callee.cls is not None and params[:1] == ["self"] else 0
    bound = []
    for i, arg in enumerate(call.args):
        if isinstance(arg, ast.Starred):
            break  # positional binding unknowable past *args
        j = i + skip_self
        if j < len(params):
            bound.append((params[j], arg))
    for kw in call.keywords:
        if kw.arg is not None:
            bound.append((kw.arg, kw.value))
    return bound


def module_name_for(relpath: str) -> str:
    """Dotted module name for a project-relative posix path."""
    mod = relpath[:-3] if relpath.endswith(".py") else relpath
    mod = mod.replace("/", ".")
    if mod.endswith(".__init__"):
        mod = mod[: -len(".__init__")]
    elif mod == "__init__":
        mod = ""
    return mod


def _resolve_relative(module: str, is_package: bool, level: int,
                      target: str) -> str:
    """``from ..p import x`` resolution: the absolute module the import
    names (without the imported symbol)."""
    parts = module.split(".") if module else []
    if not is_package:
        parts = parts[:-1]
    drop = level - 1
    if drop:
        parts = parts[: len(parts) - drop] if drop <= len(parts) else []
    if target:
        parts = parts + target.split(".")
    return ".".join(parts)


@dataclass
class FunctionInfo:
    """One function or method (any nesting level)."""

    qualname: str  # "Class.meth", "fn", "outer.<locals>.inner"
    module: str
    path: str
    node: ast.AST  # FunctionDef / AsyncFunctionDef
    cls: Optional[str] = None  # enclosing class name, if a method
    parent: Optional[str] = None  # enclosing function qualname, if nested
    params: List[str] = field(default_factory=list)
    #: how its decorators compile it (``rules.compile_mode``), or None
    compiled: Optional[str] = None

    @property
    def key(self) -> str:
        return f"{self.module}:{self.qualname}"


@dataclass
class CallSite:
    """One resolved call edge out of a function."""

    caller: str  # FunctionInfo.key
    callee: str  # FunctionInfo.key
    path: str
    line: int
    col: int
    #: with-items lexically enclosing the call (raw exprs; lockedness is
    #: evaluated after the lock-parameter fixpoint)
    with_stack: Tuple[ast.AST, ...] = ()
    in_loop: bool = False
    loop_vars: Tuple[str, ...] = ()
    call: Optional[ast.Call] = None
    #: resolution mode: "direct" (name/import) or "attr" (name-based)
    via: str = "direct"


@dataclass
class Mutation:
    """A mutation of module-level mutable state inside a function."""

    func: str  # FunctionInfo.key
    state_module: str
    state_name: str
    path: str
    line: int
    col: int
    what: str  # rendered form for the message
    with_stack: Tuple[ast.AST, ...] = ()


@dataclass
class ThreadCreation:
    """One ``threading.Thread(target=...)`` creation site (R7 pin gate)."""

    func: str  # creating FunctionInfo.key ("" at module scope)
    path: str
    line: int
    col: int
    #: resolved target function keys (name-based attr fallback may yield
    #: several candidates; empty when unresolvable)
    targets: Tuple[str, ...] = ()
    raw: str = ""  # the target expression as written


@dataclass
class SyncSite:
    """A host-device sync expression inside a function (R2x taint seed)."""

    func: str
    path: str
    line: int
    col: int
    desc: str


@dataclass
class ModuleInfo:
    name: str
    path: str
    tree: ast.Module
    is_package: bool
    imports: Dict[str, str] = field(default_factory=dict)  # alias -> dotted
    #: module-level name -> "lock" | "mutable" | "other"
    assigns: Dict[str, str] = field(default_factory=dict)
    functions: Dict[str, FunctionInfo] = field(default_factory=dict)
    classes: Dict[str, Set[str]] = field(default_factory=dict)
    global_rebinds: Set[str] = field(default_factory=set)
    #: name -> (target function qualname, compile mode) for module-level
    #: ``name = torch.compile(fn, ...)`` wrappers
    compile_aliases: Dict[str, Tuple[str, str]] = field(default_factory=dict)


class ProjectGraph:
    """The resolved whole-program view: modules, functions, edges, roots."""

    def __init__(self) -> None:
        self.modules: Dict[str, ModuleInfo] = {}
        self.functions: Dict[str, FunctionInfo] = {}
        #: method name -> sorted function keys (name-based resolution)
        self.methods: Dict[str, List[str]] = {}
        self.edges: List[CallSite] = []
        self.out_edges: Dict[str, List[CallSite]] = {}
        self.mutations: List[Mutation] = []
        self.sync_sites: List[SyncSite] = []
        #: function keys directly named as Thread targets (+ config extras)
        self.thread_roots: List[str] = []
        #: every Thread(target=...) creation site, resolved or not (R7)
        self.thread_creations: List[ThreadCreation] = []
        #: compile-decorated or module-scope compile-wrapped functions
        #: (+ config extras)
        self.jit_roots: List[str] = []
        #: instance attribute names assigned a Lock anywhere in the project
        self.lock_attrs: Set[str] = set()
        #: per-function lock-typed parameter names (fixpoint result)
        self.lock_params: Dict[str, Set[str]] = {}
        #: set by the R9 pass (analysis.lockorder.LockOrderResult) so
        #: --graph can export the lock-order graph alongside the calls
        self.lock_order = None

    # -- symbol resolution -------------------------------------------------

    def resolve(self, module: str, name: str,
                _depth: int = 0) -> Optional[Tuple[str, str]]:
        """Resolves a dotted name used in ``module`` to a defining
        ``(module, symbol)`` pair; symbol may be "" for a bare module.
        Chases import aliases and re-exports (bounded depth)."""
        if _depth > 12:
            return None
        mi = self.modules.get(module)
        if mi is None:
            return None
        # Longest alias prefix match.
        parts = name.split(".")
        for cut in range(len(parts), 0, -1):
            prefix = ".".join(parts[:cut])
            target = mi.imports.get(prefix)
            if target is None:
                continue
            rest = parts[cut:]
            full = target + ("." + ".".join(rest) if rest else "")
            return self._resolve_absolute(full, _depth)
        # A bare name defined in this module.
        if len(parts) == 1:
            if (
                parts[0] in mi.assigns
                or parts[0] in mi.functions
                or parts[0] in mi.classes
                or parts[0] in mi.compile_aliases
            ):
                return (module, parts[0])
        # "mod.sym" where the head is this very module's name is unusual;
        # fall through to absolute resolution for fully-qualified uses.
        return self._resolve_absolute(name, _depth)

    def _resolve_absolute(self, full: str,
                          _depth: int) -> Optional[Tuple[str, str]]:
        """Splits an absolute dotted path into (project module, symbol)."""
        parts = full.split(".")
        for cut in range(len(parts), 0, -1):
            mod = ".".join(parts[:cut])
            mi = self.modules.get(mod)
            if mi is None:
                continue
            rest = parts[cut:]
            if not rest:
                return (mod, "")
            sym = rest[0]
            # Re-export: the symbol is itself an import alias there.
            if sym in mi.imports and sym not in mi.assigns \
                    and sym not in mi.functions and sym not in mi.classes:
                chased = self.resolve(mod, ".".join(rest), _depth + 1)
                if chased is not None:
                    return chased
            if len(rest) == 1:
                return (mod, sym)
            # Class attribute / nested access: keep the head symbol.
            return (mod, sym)
        return None

    def expand_alias(self, module: str, name: str) -> str:
        """The absolute dotted name after expanding ``module``'s import
        aliases (one level; no project-module requirement) — for
        recognizing stdlib references like ``th.Thread`` under
        ``import threading as th``."""
        mi = self.modules.get(module)
        if mi is None:
            return name
        parts = name.split(".")
        for cut in range(len(parts), 0, -1):
            prefix = ".".join(parts[:cut])
            target = mi.imports.get(prefix)
            if target is not None:
                rest = parts[cut:]
                return target + ("." + ".".join(rest) if rest else "")
        return name

    def resolve_function(self, module: str,
                         name: str) -> Optional[FunctionInfo]:
        """Resolves a call-expression name to a project function, through
        imports and module-scope compile aliases."""
        got = self.resolve(module, name)
        if got is None:
            return None
        mod, sym = got
        mi = self.modules.get(mod)
        if mi is None or not sym:
            return None
        if sym in mi.compile_aliases:
            target, _mode = mi.compile_aliases[sym]
            return mi.functions.get(target)
        return mi.functions.get(sym)

    def specializing_callee(self, module: str,
                            name: str) -> Optional[FunctionInfo]:
        """The function when ``name`` used in ``module`` is a callable
        compiled by ``torch.compile`` without ``dynamic=True`` (it guards
        on every Python scalar argument) — via decorator or a
        module-scope ``x = torch.compile(fn)`` alias."""
        got = self.resolve(module, name)
        if got is None:
            return None
        mod, sym = got
        mi = self.modules.get(mod)
        if mi is None or not sym:
            return None
        if sym in mi.compile_aliases:
            target, mode = mi.compile_aliases[sym]
            fn = mi.functions.get(target)
            return fn if mode == "specialize" else None
        fn = mi.functions.get(sym)
        if fn is not None and fn.compiled == "specialize":
            return fn
        return None

    def is_lock_symbol(self, module: str, name: str) -> bool:
        got = self.resolve(module, name)
        if got is None:
            return False
        mod, sym = got
        mi = self.modules.get(mod)
        return mi is not None and mi.assigns.get(sym) == "lock"

    def mutable_symbol(self, module: str,
                       name: str) -> Optional[Tuple[str, str]]:
        got = self.resolve(module, name)
        if got is None:
            return None
        mod, sym = got
        mi = self.modules.get(mod)
        if mi is not None and mi.assigns.get(sym) == "mutable":
            return (mod, sym)
        return None

    # -- lockedness --------------------------------------------------------

    def _expr_is_lock(self, module: str, func: Optional[str],
                      expr: ast.AST) -> bool:
        """Is this with-item / argument expression a known lock?"""
        name = dotted(expr)
        if name is None:
            return False
        if isinstance(expr, ast.Attribute):
            if expr.attr in self.lock_attrs:
                return True
        if "." not in name and func is not None:
            if name in self.lock_params.get(func, ()):  # passed-in lock
                return True
        return self.is_lock_symbol(module, name)

    def stack_holds_lock(self, module: str, func: Optional[str],
                         with_stack: Sequence[ast.AST]) -> bool:
        return any(self._expr_is_lock(module, func, e) for e in with_stack)

    # -- reachability ------------------------------------------------------

    def unlocked_reachable(self) -> Dict[str, List[str]]:
        """Functions reachable from a thread root through edges whose call
        sites hold no lock; value = one witness path (root first)."""
        reach: Dict[str, List[str]] = {}
        frontier: List[str] = []
        for root in sorted(set(self.thread_roots)):
            if root in self.functions and root not in reach:
                reach[root] = [root]
                frontier.append(root)
        while frontier:
            frontier.sort()
            nxt: List[str] = []
            for fkey in frontier:
                fi = self.functions[fkey]
                for e in self.out_edges.get(fkey, ()):
                    if e.callee in reach or e.callee not in self.functions:
                        continue
                    if self.stack_holds_lock(fi.module, fkey, e.with_stack):
                        continue  # callee runs under a lock on this path
                    reach[e.callee] = reach[fkey] + [e.callee]
                    nxt.append(e.callee)
            frontier = nxt
        return reach

    def sync_taint(self, acknowledged: Set[Tuple[str, int]]
                   ) -> Dict[str, SyncSite]:
        """Fixpoint of "this function transitively performs a host sync".

        ``acknowledged``: (path, line) pairs carrying a valid R2/R2x
        suppression — a deliberate, justified sync does not taint its
        callers.  Value = the witness sync site (minimal (path, line))."""
        taint: Dict[str, SyncSite] = {}
        for s in sorted(self.sync_sites,
                        key=lambda s: (s.path, s.line, s.col)):
            if (s.path, s.line) in acknowledged:
                continue
            if s.func not in taint:
                taint[s.func] = s
        changed = True
        while changed:
            changed = False
            for fkey in sorted(self.functions):
                best = taint.get(fkey)
                for e in self.out_edges.get(fkey, ()):
                    w = taint.get(e.callee)
                    if w is None:
                        continue
                    if best is None or (w.path, w.line, w.col) < (
                        best.path, best.line, best.col
                    ):
                        best = w
                if best is not None and taint.get(fkey) is not best:
                    if fkey not in taint or (
                        (best.path, best.line, best.col)
                        < (taint[fkey].path, taint[fkey].line,
                           taint[fkey].col)
                    ):
                        taint[fkey] = best
                        changed = True
        return taint

    def call_index(self, fkey: str) -> Dict[Tuple[int, int], List[str]]:
        """(line, col) of each resolved call inside ``fkey`` -> sorted
        callee keys.  Lets a lexical pass (R10's branch-side walk) look
        up which project functions a given ``ast.Call`` resolves to."""
        idx: Dict[Tuple[int, int], List[str]] = {}
        for e in self.out_edges.get(fkey, ()):
            idx.setdefault((e.line, e.col), []).append(e.callee)
        for v in idx.values():
            v.sort()
        return idx

    def reach_witness(self, seeds: Dict[str, str]) -> Dict[str, str]:
        """Fixpoint of "this function transitively reaches a seeded site".

        ``seeds``: function key -> witness description.  Result maps every
        function that reaches a seed through call edges to the minimal
        witness string (deterministic: same shape as ``sync_taint`` but
        generic over what the seeds mean — R10 seeds agreement sites,
        R11 seeds nondeterminism sources)."""
        reach = dict(seeds)
        changed = True
        while changed:
            changed = False
            for fkey in sorted(self.functions):
                best = reach.get(fkey)
                for e in self.out_edges.get(fkey, ()):
                    w = reach.get(e.callee)
                    if w is not None and (best is None or w < best):
                        best = w
                if best is not None and reach.get(fkey) != best:
                    reach[fkey] = best
                    changed = True
        return reach

    # -- serialization -----------------------------------------------------

    def as_json(self) -> dict:
        """Deterministic JSON view for ``--graph`` debugging."""
        return {
            "modules": sorted(self.modules),
            "functions": {
                k: {
                    "path": fi.path,
                    "line": fi.node.lineno,
                    "class": fi.cls,
                    "compiled": fi.compiled,
                }
                for k, fi in sorted(self.functions.items())
            },
            "edges": [
                {
                    "caller": e.caller,
                    "callee": e.callee,
                    "path": e.path,
                    "line": e.line,
                    "locked": self.stack_holds_lock(
                        self.functions[e.caller].module, e.caller,
                        e.with_stack,
                    ),
                    "in_loop": e.in_loop,
                    "via": e.via,
                }
                for e in sorted(
                    self.edges,
                    key=lambda e: (e.path, e.line, e.col, e.caller, e.callee),
                )
            ],
            "thread_roots": sorted(set(self.thread_roots)),
            "jit_roots": sorted(set(self.jit_roots)),
            "lock_attrs": sorted(self.lock_attrs),
            "lock_params": {
                k: sorted(v)
                for k, v in sorted(self.lock_params.items())
                if v
            },
        }


# --------------------------------------------------------------------------
# module indexing


_ABS_LOCK_CTORS = frozenset(
    {"threading.Lock", "threading.RLock", "threading.Condition"}
)


def _expand_imports(imports: Dict[str, str], name: str) -> str:
    """Longest-prefix import-alias expansion of a dotted name (e.g.
    ``_threading.Lock`` -> ``threading.Lock`` under ``import threading
    as _threading``)."""
    parts = name.split(".")
    for cut in range(len(parts), 0, -1):
        target = imports.get(".".join(parts[:cut]))
        if target is not None:
            rest = parts[cut:]
            return target + ("." + ".".join(rest) if rest else "")
    return name


def is_lock_ctor(name: Optional[str],
                 imports: Optional[Dict[str, str]] = None) -> bool:
    """Is this dotted call name a Lock/RLock/Condition constructor,
    including through an import alias (``import threading as _th``)?"""
    if name is None:
        return False
    if name in _LOCK_CTORS:
        return True
    if imports is not None:
        return _expand_imports(imports, name) in _ABS_LOCK_CTORS
    return False


def _classify_module_assign(value: ast.AST,
                            imports: Optional[Dict[str, str]] = None) -> str:
    vname = dotted(value.func) if isinstance(value, ast.Call) else None
    if is_lock_ctor(vname, imports):
        return "lock"
    if isinstance(value, (ast.List, ast.Dict, ast.Set)) or (
        vname in _MUTABLE_CTORS
    ):
        return "mutable"
    return "other"


def index_module(relpath: str, tree: ast.Module) -> ModuleInfo:
    name = module_name_for(relpath)
    mi = ModuleInfo(
        name=name,
        path=relpath,
        tree=tree,
        is_package=relpath.endswith("__init__.py"),
    )

    for node in tree.body:
        if isinstance(node, ast.Import):
            for al in node.names:
                mi.imports[al.asname or al.name] = al.name
        elif isinstance(node, ast.ImportFrom):
            base = _resolve_relative(
                name, mi.is_package, node.level, node.module or ""
            ) if node.level else (node.module or "")
            for al in node.names:
                if al.name == "*":
                    continue
                mi.imports[al.asname or al.name] = (
                    f"{base}.{al.name}" if base else al.name
                )
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [
                node.target
            ]
            value = node.value
            if value is None:
                continue
            for t in targets:
                if not isinstance(t, ast.Name):
                    continue
                mi.assigns[t.id] = _classify_module_assign(value, mi.imports)
                # Module-scope compile wrapper: name = torch.compile(fn)
                call = _compile_call_of(value)
                if call is not None and call.args and isinstance(
                    call.args[0], ast.Name
                ):
                    mi.compile_aliases[t.id] = (
                        call.args[0].id, compile_mode(value)
                    )

    # Functions (all nesting levels) and classes, with qualnames.
    def add_function(node, qual: str, cls: Optional[str],
                     parent: Optional[str]) -> None:
        fi = FunctionInfo(
            qualname=qual,
            module=name,
            path=relpath,
            node=node,
            cls=cls,
            parent=parent,
            params=[a.arg for a in node.args.posonlyargs + node.args.args],
        )
        fi.compiled = function_compile_mode(node)
        mi.functions[qual] = fi
        walk_defs(node.body, f"{qual}.<locals>.", None, qual)

    def walk_defs(body, qual_prefix: str, cls: Optional[str],
                  parent: Optional[str]) -> None:
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                add_function(node, f"{qual_prefix}{node.name}", cls, parent)
            elif isinstance(node, ast.ClassDef):
                methods = {
                    sub.name
                    for sub in node.body
                    if isinstance(sub,
                                  (ast.FunctionDef, ast.AsyncFunctionDef))
                }
                mi.classes[node.name] = methods
                # methods get "Class.meth" qualnames
                for sub in node.body:
                    if isinstance(sub,
                                  (ast.FunctionDef, ast.AsyncFunctionDef)):
                        add_function(
                            sub, f"{node.name}.{sub.name}", node.name, None
                        )

    walk_defs(tree.body, "", None, None)

    # Drop compile aliases whose wrapped function isn't a module-level def.
    for alias, (target, _m) in list(mi.compile_aliases.items()):
        if target not in mi.functions:
            del mi.compile_aliases[alias]

    # global-rebound module names count as mutable scalar state
    for node in ast.walk(tree):
        if isinstance(node, ast.Global):
            for n in node.names:
                mi.global_rebinds.add(n)
                if n in mi.assigns and mi.assigns[n] == "other":
                    mi.assigns[n] = "mutable"
    return mi


# --------------------------------------------------------------------------
# per-function body scan (calls, mutations, syncs, thread targets)


class _BodyScan(ast.NodeVisitor):
    """Walks ONE function's body (skipping nested defs — they are their
    own graph nodes), collecting call sites with their with/loop
    context, mutations of module-level state, and sync expressions."""

    def __init__(self, graph: ProjectGraph, mi: ModuleInfo,
                 fi: FunctionInfo) -> None:
        self.g = graph
        self.mi = mi
        self.fi = fi
        self.with_stack: List[ast.AST] = []
        self.loop_depth = 0
        self.loop_vars: List[Set[str]] = []
        self.globals_declared: Set[str] = set()
        for node in ast.walk(fi.node):
            if isinstance(node, ast.Global):
                self.globals_declared.update(node.names)
        # Names bound in THIS function's scope (params + assignments +
        # loop/with/except targets, nested defs excluded): a bare use of
        # one refers to the local, not to same-named module state — it
        # must not resolve through the project symbol table.
        self.local_names = _locally_bound_names(fi.node)
        self.local_names -= self.globals_declared
        self.local_types = self._local_class_types()

    def _local_class_types(self) -> Dict[str, str]:
        """Locals bound to an instance of ONE project class by a
        constructor call in this function's own body (``h = Histogram()``)
        -> that class's "module:Class".  Their method calls resolve to
        the class's own method instead of every same-named project
        method.  A local constructed from two classes is left out."""
        seen: Dict[str, Set[str]] = {}
        for node in iter_body_nodes(self.fi.node):
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)):
                continue
            cname = dotted(node.value.func)
            got = (
                self.g.resolve(self.mi.name, cname)
                if cname is not None and not self._shadowed(cname)
                else None
            )
            if got is None:
                continue
            mod, sym = got
            mi = self.g.modules.get(mod)
            if mi is None or sym not in mi.classes:
                continue
            for t in node.targets:
                if isinstance(t, ast.Name):
                    seen.setdefault(t.id, set()).add(f"{mod}:{sym}")
        return {k: next(iter(v)) for k, v in seen.items() if len(v) == 1}

    def _shadowed(self, name: str) -> bool:
        return name.split(".", 1)[0] in self.local_names

    def run(self) -> None:
        for stmt in self.fi.node.body:
            self.visit(stmt)

    # ---- context tracking

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass  # nested defs scanned as their own functions

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        pass

    def visit_With(self, node: ast.With) -> None:
        self.with_stack.extend(item.context_expr for item in node.items)
        for child in node.body:
            self.visit(child)
        del self.with_stack[len(self.with_stack) - len(node.items):]
        for item in node.items:
            self.visit(item.context_expr)

    def visit_For(self, node: ast.For) -> None:
        self.loop_vars.append(scalar_loop_targets(node))
        self.loop_depth += 1
        for child in node.body:
            self.visit(child)
        self.loop_depth -= 1
        self.loop_vars.pop()
        # the else: body and the iterable run once, outside the loop
        for child in node.orelse:
            self.visit(child)
        self.visit(node.iter)

    def visit_While(self, node: ast.While) -> None:
        self.loop_vars.append(set())
        self.loop_depth += 1
        # the test re-evaluates every iteration: it IS loop context
        self.visit(node.test)
        for child in node.body:
            self.visit(child)
        self.loop_depth -= 1
        self.loop_vars.pop()
        for child in node.orelse:
            self.visit(child)

    # ---- mutations and syncs

    def _all_loop_vars(self) -> Tuple[str, ...]:
        out: Set[str] = set()
        for frame in self.loop_vars:
            out |= frame
        return tuple(sorted(out))

    def _note_mutation(self, node: ast.AST, mod: str, sym: str,
                       what: str) -> None:
        self.g.mutations.append(
            Mutation(
                func=self.fi.key,
                state_module=mod,
                state_name=sym,
                path=self.fi.path,
                line=node.lineno,
                col=node.col_offset,
                what=what,
                with_stack=tuple(self.with_stack),
            )
        )

    def visit_Assign(self, node: ast.Assign) -> None:
        self._check_store_targets(node.targets)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_store_targets([node.target])
        self.generic_visit(node)

    def _check_store_targets(self, targets) -> None:
        for t in targets:
            if isinstance(t, ast.Name) and t.id in self.globals_declared:
                if self.mi.assigns.get(t.id) in ("mutable", "other"):
                    self._note_mutation(
                        t, self.mi.name, t.id, f"'{t.id}'"
                    )
            elif isinstance(t, ast.Subscript):
                name = dotted(t.value)
                if name is None or self._shadowed(name):
                    continue
                got = self.g.mutable_symbol(self.mi.name, name)
                if got is not None:
                    self._note_mutation(
                        t, got[0], got[1], f"'{name}[...]'"
                    )

    def visit_Call(self, node: ast.Call) -> None:
        self._check_thread_ctor(node)
        self._check_sync(node)
        name = dotted(node.func)
        if name is not None:
            # container mutator on resolved module-level state
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _MUTATORS:
                base = dotted(node.func.value)
                if base is not None and not self._shadowed(base):
                    got = self.g.mutable_symbol(self.mi.name, base)
                    if got is not None:
                        self._note_mutation(
                            node, got[0], got[1],
                            f"'{base}.{node.func.attr}()'",
                        )
            self._add_call_edges(node, name)
        self.generic_visit(node)

    def _resolve_local(self, name: str) -> Optional[FunctionInfo]:
        """A bare name in this function's scope: a nested function of
        this (or an enclosing) function, else — unless a parameter or
        local variable shadows it — a module-level/imported function."""
        scope = self.fi.qualname
        while True:
            cand = f"{scope}.<locals>.{name}"
            if cand in self.mi.functions:
                return self.mi.functions[cand]
            owner = self.mi.functions.get(scope)
            if owner is None or owner.parent is None:
                break
            scope = owner.parent
        if self._shadowed(name):
            return None  # the call targets the local, not module scope
        return self.g.resolve_function(self.mi.name, name)

    def _add_call_edges(self, node: ast.Call, name: str) -> None:
        fi = self.fi
        callees: List[Tuple[str, str]] = []  # (key, via)
        if "." not in name:
            target = self._resolve_local(name)
            if target is not None:
                callees.append((target.key, "direct"))
        elif name.startswith("self.") and fi.cls is not None and \
                name.count(".") == 1:
            meth = name.split(".", 1)[1]
            cand = f"{fi.cls}.{meth}"
            if cand in self.mi.functions:
                callees.append(
                    (f"{self.mi.name}:{cand}", "direct")
                )
            else:
                callees.extend(
                    (k, "attr") for k in self._named_methods(meth)
                )
        elif name.count(".") == 1 and self._typed_method(name) is not None:
            callees.append((self._typed_method(name), "direct"))
        else:
            # a local binding of the head name shadows any same-named
            # module/import symbol — only name-based fallback applies
            target = (
                None
                if self._shadowed(name)
                else self.g.resolve_function(self.mi.name, name)
            )
            if target is not None:
                callees.append((target.key, "direct"))
            elif not self._external(name):
                meth = name.rsplit(".", 1)[1]
                callees.extend(
                    (k, "attr") for k in self._named_methods(meth)
                )
        for key, via in callees:
            self.g.edges.append(
                CallSite(
                    caller=fi.key,
                    callee=key,
                    path=fi.path,
                    line=node.lineno,
                    col=node.col_offset,
                    with_stack=tuple(self.with_stack),
                    in_loop=self.loop_depth > 0,
                    loop_vars=self._all_loop_vars(),
                    call=node,
                    via=via,
                )
            )

    def _typed_method(self, name: str) -> Optional[str]:
        """``local.meth`` on a local of known project class (see
        :meth:`_local_class_types`): the class's own method key, or None
        when the class does not define it (inherited or dynamic)."""
        head, meth = name.split(".", 1)
        cls_key = self.local_types.get(head)
        if cls_key is None:
            return None
        key = f"{cls_key}.{meth}"
        return key if key in self.g.functions else None

    def _external(self, name: str) -> bool:
        """Is the head of a dotted call name an import of a module outside
        the project (``torch.from_numpy``, ``np.asarray``)?  Its methods
        are that library's, never a same-named project method."""
        head = name.split(".", 1)[0]
        if self._shadowed(head) or head not in self.mi.imports:
            return False
        return self.g.resolve(self.mi.name, head) is None

    def _named_methods(self, meth: str) -> List[str]:
        if meth in _COMMON_METHOD_NAMES:
            return []
        return self.g.methods.get(meth, [])

    def _check_thread_ctor(self, node: ast.Call) -> None:
        name = dotted(node.func)
        if name is None:
            return
        if name not in _THREAD_CTORS:
            # import threading as th; th.Thread(...) — expand the alias
            if self.g.expand_alias(self.mi.name, name) != "threading.Thread":
                return
        for kw in node.keywords:
            if kw.arg != "target":
                continue
            v = kw.value
            fi = self.fi
            targets: List[str] = []
            if isinstance(v, ast.Name):
                target = self._resolve_local(v.id)
                if target is not None:
                    targets.append(target.key)
            elif isinstance(v, ast.Attribute):
                meth = v.attr
                if (
                    isinstance(v.value, ast.Name)
                    and v.value.id == "self"
                    and fi.cls is not None
                    and f"{fi.cls}.{meth}" in self.mi.functions
                ):
                    targets.append(f"{self.mi.name}:{fi.cls}.{meth}")
                else:
                    # same common-name guard as call edges: a target
                    # named like a builtin container/queue method must
                    # not make every same-named project method a root
                    targets.extend(self._named_methods(meth))
            self.g.thread_roots.extend(targets)
            self.g.thread_creations.append(
                ThreadCreation(
                    func=fi.key,
                    path=fi.path,
                    line=node.lineno,
                    col=node.col_offset,
                    targets=tuple(targets),
                    raw=dotted(v) or type(v).__name__,
                )
            )

    # ---- sync sites (R2x taint seeds)

    def _check_sync(self, node: ast.Call) -> None:
        got = classify_sync(node)
        if got is not None:
            self.g.sync_sites.append(
                SyncSite(
                    func=self.fi.key,
                    path=self.fi.path,
                    line=node.lineno,
                    col=node.col_offset,
                    desc=got[1],
                )
            )


# --------------------------------------------------------------------------
# graph construction


def build_graph(
    trees: Dict[str, ast.Module],
    thread_root_config: Sequence[str] = (),
    jit_root_config: Sequence[str] = (),
) -> ProjectGraph:
    """Builds the whole-program graph from {relpath: parsed tree}.

    ``thread_root_config`` / ``jit_root_config``: extra roots from
    ``[tool.torchlint]``, each "module.dotted:Qual.Name" or a bare
    "Qual.Name" (matched against every module)."""
    g = ProjectGraph()
    for relpath in sorted(trees):
        mi = index_module(relpath, trees[relpath])
        g.modules[mi.name] = mi
        for fi in mi.functions.values():
            g.functions[fi.key] = fi

    # Name-based method table and project-wide lock attrs.
    for mname in sorted(g.modules):
        mi = g.modules[mname]
        for qual in sorted(mi.functions):
            fi = mi.functions[qual]
            if fi.cls is not None:
                meth = qual.rsplit(".", 1)[1]
                g.methods.setdefault(meth, []).append(fi.key)
        for node in ast.walk(mi.tree):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                        and isinstance(node.value, ast.Call)
                        and is_lock_ctor(dotted(node.value.func), mi.imports)
                    ):
                        g.lock_attrs.add(t.attr)
    for meth in g.methods:
        g.methods[meth].sort()

    # Body scans (deterministic order).
    for mname in sorted(g.modules):
        mi = g.modules[mname]
        for qual in sorted(mi.functions):
            _BodyScan(g, mi, mi.functions[qual]).run()

    g.out_edges = {}
    for e in sorted(
        g.edges, key=lambda e: (e.caller, e.path, e.line, e.col, e.callee)
    ):
        g.out_edges.setdefault(e.caller, []).append(e)

    # Configured extra roots.  Bare specs match the qualname with or
    # without its ``<locals>`` segments ("run_with_deadline.work" pins
    # the nested ``run_with_deadline.<locals>.work``); module-qualified
    # specs get the same tolerance on their qualname half.
    def match_config_roots(specs: Sequence[str]) -> List[str]:
        out: List[str] = []
        for spec in specs:
            for key in sorted(g.functions):
                if spec_matches_function(spec, key):
                    out.append(key)
        return out

    g.thread_roots.extend(match_config_roots(thread_root_config))

    # Compile-boundary roots: decorated functions + module-scope aliases.
    for mname in sorted(g.modules):
        mi = g.modules[mname]
        for qual in sorted(mi.functions):
            if mi.functions[qual].compiled is not None:
                g.jit_roots.append(mi.functions[qual].key)
        for alias in sorted(mi.compile_aliases):
            target, _ = mi.compile_aliases[alias]
            g.jit_roots.append(f"{mname}:{target}")
    g.jit_roots.extend(match_config_roots(jit_root_config))

    # Lock-parameter fixpoint: a parameter is lock-typed when any call
    # site passes a known lock (module lock, lock attr, or another
    # function's lock param) in its position.
    g.lock_params = {k: set() for k in g.functions}
    for _round in range(8):
        changed = False
        for e in g.edges:
            if e.call is None or e.callee not in g.functions:
                continue
            callee = g.functions[e.callee]
            caller = g.functions.get(e.caller)
            cmod = caller.module if caller is not None else ""
            for pname, expr in bind_call_args(callee, e.call):
                if pname in g.lock_params[e.callee]:
                    continue
                if g._expr_is_lock(cmod, e.caller, expr):
                    g.lock_params[e.callee].add(pname)
                    changed = True
        if not changed:
            break

    g.thread_roots = sorted(set(g.thread_roots))
    g.jit_roots = sorted(set(g.jit_roots))
    return g
