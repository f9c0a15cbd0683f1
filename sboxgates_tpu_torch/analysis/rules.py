"""torchlint rule implementations (stdlib ``ast`` only — no new deps).

The per-file rules target the PyTorch failure modes that erase
streaming-search throughput on the card:

R1  recompilation hazards — ``torch.compile`` / ``torch.jit.script`` /
    ``torch.jit.trace`` built inside a loop (a fresh compiled callable
    with an empty guard cache per iteration), and call sites of a
    ``torch.compile``'d function that pass a Python scalar varying with
    the enclosing loop (``torch.compile`` specializes on Python scalars:
    every distinct value is a recompile until the recompile limit drops
    the function to eager).
R2  host-device synchronization inside a loop in a *hot* module
    (``[tool.torchlint] hot_modules``): ``.item()``, ``.cpu()``,
    ``.tolist()``, ``.numpy()``, ``torch.cuda.synchronize()`` and
    ``Event``/``Stream.synchronize()``, ``np.asarray``/``np.array`` on a
    non-host expression, and ``int()``/``float()``/``bool()`` wrapped
    directly around a ``torch.*`` call.  Each sync stalls the launch
    queue; inside the streaming sweeps that is the whole ballgame.
R3  capture escape — storing to ``self``/``global`` state, or creating a
    ``threading.Thread``, inside a ``torch.cuda.graph`` capture or a
    function compiled with ``torch.compile`` / ``torch.jit``: a replayed
    graph re-runs the kernels but not the Python side effect, and a
    compiled function breaks its graph (or bakes a stale value) there.
R4  lock discipline — module-level mutable state mutated inside a
    ``threading.Thread`` target without holding a ``Lock``/``Condition``
    belonging to the same module.
R5  swallowed errors — ``except Exception`` / bare ``except`` whose body
    neither re-raises nor logs.

Findings are suppressed inline with ``# torchlint: ignore[R2] reason`` (the
reason is mandatory; a reason-less marker suppresses nothing and is itself
reported as SUP).  The suppression comment lives on the offending line or
on its own line directly above.
"""

from __future__ import annotations

import ast
import re
import tokenize
from dataclasses import dataclass, field
from io import StringIO
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .config import TorchlintConfig

#: Rule used for invalid/reason-less suppression markers; never
#: suppressible itself.
SUPPRESSION_RULE = "SUP"
#: Rule used for files that fail to parse.
PARSE_RULE = "ERR"

RULE_DOCS = {
    "R1": (
        "recompilation hazard (torch.compile/torch.jit built in a loop / "
        "loop-varying Python scalar passed to a compiled function)"
    ),
    "R2": "host-device sync inside a loop in a hot module",
    "R3": (
        "capture escape (self/global store or thread hand-off inside a "
        "CUDA graph capture or a compiled function)"
    ),
    "R4": "module state mutated in a thread target without its module lock",
    "R5": "except Exception/bare except that neither re-raises nor logs",
    "R6": (
        "direct stats-dict mutation outside telemetry/ (an unlocked "
        "read-modify-write loses updates under thread races; use the "
        "metrics facade: stats.inc/put/observe/ensure/merge)"
    ),
    "R1x": (
        "cross-module recompilation hazard (loop-varying Python scalar "
        "at a call site of a compiled function defined elsewhere)"
    ),
    "R2x": (
        "interprocedural host sync: a hot-module loop calls a helper that "
        "transitively blocks on the device"
    ),
    "R4x": (
        "module state mutated on an unlocked path reachable from a thread "
        "entry (transitive reachability; locks may be imported, "
        "re-exported, or passed as parameters)"
    ),
    "R7": (
        "registry drift: a use site bypassing or undeclared in one of the "
        "declared registries (kernel registry / METRICS / fault sites / "
        "journal config keys / pinned thread roots), or a declared entry "
        "with no reachable use site"
    ),
    "R8": (
        "bucket discipline: an operand shape at a registered-kernel "
        "dispatch site derives from a non-bucketed dynamic value — every "
        "distinct shape is a fresh compile (pad to the declared bucket "
        "ladders: bucket_size/PIVOT_G_BUCKETS/FLEET_BUCKETS/"
        "STACKED_BUCKETS)"
    ),
    "R9": (
        "lock-order hazard: a cycle in the lock-acquisition-order graph "
        "over the thread roots (potential deadlock), or a lock held "
        "across a blocking dispatch/verdict resolve (deadlocks against "
        "the abandonment path)"
    ),
    "R10": (
        "replicated-protocol divergence: an agreement/collective site "
        "(breach_verdict, journal_seq_check, _kv_exchange, device "
        "collectives, replicated dispatch) reached from only one side of "
        "a rank-gated branch, or a device collective issued inside a "
        "host-agreement window — every process must issue the same "
        "agreement sequence or the pod hangs (launch-count lockstep)"
    ),
    "R11": (
        "determinism taint: a nondeterministic source (wall clock, "
        "unseeded RNG, os.urandom, uuid, unsorted directory scan, set "
        "iteration, id()) flows into a bit-identity sink (journal append, "
        "checkpoint bytes, canonical store keys, seed derivation) — "
        "breaks bit-identical resume and cross-process key agreement"
    ),
    "R12": (
        "durability discipline: a truncating open / json.dump / "
        "os.replace in a persistence module bypasses the shared "
        "tmp+fsync+atomic-replace helper (durable_write_text) — a kill "
        "mid-write leaves a torn file the recovery path must never see"
    ),
    "R13": (
        "untrusted-input taint: a request-derived value (headers, body "
        "fields, query params, path segments) reaches a sensitive sink "
        "(filesystem path construction, journal/store record fields, "
        "faults.set_tenant, process spawns) without passing a declared "
        "sanitizer (schema validator, int/range coercion, canonical-key "
        "or digest derivation) — path traversal and unvalidated tenant "
        "names, caught structurally"
    ),
    "R14": (
        "admission-order discipline: an effectful call in a handler "
        "body (orchestrator enqueue/join, durable admission record) not "
        "dominated by the auth+quota check sites, or a 2xx admission "
        "response not dominated by the fsync'd admission-journal append "
        "— the fail-closed-auth-before-effects and journal-before-202 "
        "contracts, on every path"
    ),
    "R15": (
        "resource lifecycle: a socket/listener/thread/temp-file "
        "acquisition not released on all exit paths (with/try-finally, "
        "ownership transfer via return or hand-off, teardown-registry "
        "registration, or a class teardown for self-stored resources) — "
        "a failed bind must never leak an ephemeral listener"
    ),
    "COV": (
        "chaos coverage: a declared fault site (faults.KNOWN_SITES) with "
        "no armed test and no [tool.torchlint] chaos_waivers entry, or a "
        "stale waiver naming a site no longer declared"
    ),
    SUPPRESSION_RULE: (
        "malformed or unused torchlint suppression (reason is mandatory; a "
        "marker whose finding no longer fires is itself a finding)"
    ),
    PARSE_RULE: "file failed to parse",
}


@dataclass(frozen=True)
class Finding:
    path: str  # project-relative posix path
    line: int
    col: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"

    def as_json(self) -> dict:
        return {
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "rule": self.rule,
            "message": self.message,
        }


# --------------------------------------------------------------------------
# shared AST helpers


def dotted(node: ast.AST) -> Optional[str]:
    """'torch.compile' for Attribute/Name chains; None for anything else."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


#: Calls that build a compiled callable.  ``compile`` alone is Python's
#: builtin, never torch's, so only the qualified spellings count.
_COMPILE_NAMES = {
    "torch.compile",
    "torch.jit.script",
    "torch.jit.trace",
    "torch.jit.trace_module",
    "jit.script",
    "jit.trace",
}
_PARTIAL_NAMES = {"functools.partial", "partial"}


def _compile_call_of(node: ast.AST) -> Optional[ast.Call]:
    """The Call node that *creates* a compiled function, if ``node`` is one.

    Matches ``torch.compile(...)`` / ``torch.jit.script(...)`` /
    ``torch.jit.trace(...)`` and ``functools.partial(torch.compile, ...)``
    (decorator form).
    """
    if not isinstance(node, ast.Call):
        return None
    name = dotted(node.func)
    if name in _COMPILE_NAMES:
        return node
    if name in _PARTIAL_NAMES and node.args:
        if dotted(node.args[0]) in _COMPILE_NAMES:
            return node
    return None


def compile_mode(node: ast.AST) -> Optional[str]:
    """How a decorator or call compiles: "specialize" for
    ``torch.compile`` without ``dynamic=True`` (Python scalar arguments are
    guarded on: every new value recompiles), "dynamic" for
    ``torch.compile(dynamic=True)``, "script" for ``torch.jit``; None when
    ``node`` compiles nothing.  A bare ``@torch.compile`` decorator is
    "specialize"."""
    name = dotted(node)
    if name in _COMPILE_NAMES:
        return "specialize" if name == "torch.compile" else "script"
    call = _compile_call_of(node)
    if call is None:
        return None
    fn = dotted(call.func)
    if fn in _PARTIAL_NAMES:
        fn = dotted(call.args[0])
    if fn != "torch.compile":
        return "script"
    for kw in call.keywords:
        if (
            kw.arg == "dynamic"
            and isinstance(kw.value, ast.Constant)
            and kw.value.value is True
        ):
            return "dynamic"
    return "specialize"


def function_compile_mode(fn: ast.AST) -> Optional[str]:
    """The compile mode of a def's decorators (see :func:`compile_mode`)."""
    if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return None
    for dec in fn.decorator_list:
        mode = compile_mode(dec)
        if mode is not None:
            return mode
    return None


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def scalar_loop_targets(node: ast.For) -> Set[str]:
    """Loop-target names bound to Python ints: ``for i in range(...)``,
    and the index of ``for i, x in enumerate(...)``.  Targets of any other
    iterable may be tensors, which a compiled function does not guard on
    by value."""
    it = node.iter
    if not isinstance(it, ast.Call):
        return set()
    name = dotted(it.func)
    if name == "range":
        return _names_in(node.target)
    if (
        name == "enumerate"
        and isinstance(node.target, (ast.Tuple, ast.List))
        and node.target.elts
        and isinstance(node.target.elts[0], ast.Name)
    ):
        return {node.target.elts[0].id}
    return set()


def varying_scalar_message(pname: str, where: str) -> str:
    """The R1/R1x message for a loop-varying Python scalar argument."""
    return (
        f"Python scalar argument '{pname}' of {where} varies with the "
        "enclosing loop: torch.compile specializes on Python scalars, so "
        "every iteration recompiles (and past the recompile limit the "
        "function silently runs eagerly) — pass a tensor, or compile "
        "with dynamic=True"
    )


# --------------------------------------------------------------------------
# R1 — recompilation hazards


class _R1(ast.NodeVisitor):
    def __init__(self) -> None:
        self.findings: List[Tuple[int, int, str]] = []
        self._loop_vars: List[Set[str]] = []  # one frame per enclosing For
        self._in_loop = 0
        #: name -> parameter names, for module/class fns compiled with
        #: torch.compile (specializing on Python scalars)
        self._specialized: Dict[str, List[str]] = {}

    # -- pass 1: collect compiled defs and module-scope compile aliases
    def collect(self, tree: ast.Module) -> None:
        defs: Dict[str, List[str]] = {}
        for node in ast.walk(tree):
            if not isinstance(node, ast.FunctionDef):
                continue
            params = [a.arg for a in node.args.posonlyargs + node.args.args]
            defs[node.name] = params
            if function_compile_mode(node) == "specialize":
                self._specialized[node.name] = params
        for node in tree.body:
            if not isinstance(node, ast.Assign):
                continue
            call = _compile_call_of(node.value)
            if (
                call is None
                or compile_mode(node.value) != "specialize"
                or not call.args
                or not isinstance(call.args[0], ast.Name)
                or call.args[0].id not in defs
            ):
                continue
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self._specialized[t.id] = defs[call.args[0].id]

    # -- pass 2: walk, tracking loops
    def visit_For(self, node: ast.For) -> None:
        self._loop_vars.append(scalar_loop_targets(node))
        self._in_loop += 1
        for child in node.body:
            self.visit(child)
        self._in_loop -= 1
        self._loop_vars.pop()
        # the else: body and the iterable run once, outside the loop
        for child in node.orelse:
            self.visit(child)
        self.visit(node.iter)

    def visit_While(self, node: ast.While) -> None:
        self._loop_vars.append(set())
        self._in_loop += 1
        # the test re-evaluates every iteration: it IS loop context
        self.visit(node.test)
        for child in node.body:
            self.visit(child)
        self._in_loop -= 1
        self._loop_vars.pop()
        for child in node.orelse:
            self.visit(child)

    def _all_loop_vars(self) -> Set[str]:
        out: Set[str] = set()
        for frame in self._loop_vars:
            out |= frame
        return out

    def visit_Call(self, node: ast.Call) -> None:
        if self._in_loop and _compile_call_of(node) is not None:
            self.findings.append(
                (
                    node.lineno,
                    node.col_offset,
                    "compiled callable built inside a loop: each iteration "
                    "gets a fresh torch.compile/torch.jit object with an "
                    "empty guard cache, so every iteration compiles again "
                    "— hoist it out of the loop (memoize by config key)",
                )
            )
        name = dotted(node.func)
        if name in self._specialized:
            self._check_scalar_args(node, name, self._specialized[name])
        self.generic_visit(node)

    def _check_scalar_args(
        self, call: ast.Call, name: str, params: List[str]
    ) -> None:
        loop_vars = self._all_loop_vars()
        if not loop_vars:
            return
        bound: List[Tuple[str, ast.AST]] = []
        for i, arg in enumerate(call.args):
            if isinstance(arg, ast.Starred):
                break
            if i < len(params):
                bound.append((params[i], arg))
        for kw in call.keywords:
            if kw.arg is not None:
                bound.append((kw.arg, kw.value))
        for pname, expr in bound:
            if _names_in(expr) & loop_vars:
                self.findings.append(
                    (
                        expr.lineno,
                        expr.col_offset,
                        varying_scalar_message(
                            pname, f"compiled '{name}'"
                        ),
                    )
                )


# --------------------------------------------------------------------------
# R2 — host-device sync inside loops (hot modules only)

_SYNC_FUNCS = {
    "torch.cuda.synchronize": "torch.cuda.synchronize",
}
#: Tensor methods that copy to the host and wait for the queue.
_TO_HOST_METHODS = {"cpu", "tolist", "numpy"}
_ASARRAY_FUNCS = {"np.asarray", "numpy.asarray", "np.array", "numpy.array"}
_HOSTY_CALLS = {"list", "tuple", "sorted", "range", "len", "dict", "zip"}


def _hosty_arg(node: ast.AST) -> bool:
    """True when the expression is clearly host data already (a display,
    a comprehension, or a list()/range()-style builtin call) — converting
    it cannot trigger a device sync."""
    if isinstance(
        node,
        (
            ast.List,
            ast.Tuple,
            ast.Dict,
            ast.Set,
            ast.ListComp,
            ast.SetComp,
            ast.GeneratorExp,
            ast.Constant,
        ),
    ):
        return True
    if isinstance(node, ast.Call) and dotted(node.func) in _HOSTY_CALLS:
        return True
    return False


def _contains_torch_call(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            name = dotted(n.func)
            if name and name.startswith("torch."):
                return True
    return False


def classify_sync(node: ast.Call) -> Optional[Tuple[str, str]]:
    """(kind, short description) when the call is a host-device sync
    pattern, else None.  ONE classifier for the per-file R2 and the
    cross-module R2x taint seeding — the two must never drift."""
    name = dotted(node.func)
    if name in _SYNC_FUNCS:
        return "sync_func", f"{name}()"
    if isinstance(node.func, ast.Attribute) and not node.args:
        attr = node.func.attr
        if attr == "synchronize":
            return "synchronize", ".synchronize()"
        if attr == "item":
            return "item", ".item()"
        if attr in _TO_HOST_METHODS and not node.keywords:
            return "to_host", f".{attr}()"
    if name in _ASARRAY_FUNCS and node.args:
        if not _hosty_arg(node.args[0]):
            return "asarray", f"{name}() on a possibly-device value"
        return None
    if name in ("int", "float", "bool") and len(node.args) == 1:
        if _contains_torch_call(node.args[0]):
            return "cast", f"{name}() around a torch call"
    return None


class _R2(ast.NodeVisitor):
    def __init__(self) -> None:
        self.findings: List[Tuple[int, int, str]] = []
        self._in_loop = 0

    def visit_For(self, node: ast.For) -> None:
        self._in_loop += 1
        for child in node.body:
            self.visit(child)
        self._in_loop -= 1
        # the else: body and the iterable run once, outside the loop
        for child in node.orelse:
            self.visit(child)
        self.visit(node.iter)

    def visit_While(self, node: ast.While) -> None:
        self._in_loop += 1
        # the test re-evaluates every iteration: it IS loop context
        self.visit(node.test)
        for child in node.body:
            self.visit(child)
        self._in_loop -= 1
        for child in node.orelse:
            self.visit(child)

    def visit_Call(self, node: ast.Call) -> None:
        if self._in_loop:
            self._check(node)
        self.generic_visit(node)

    def _flag(self, node: ast.AST, msg: str) -> None:
        self.findings.append((node.lineno, node.col_offset, msg))

    def _check(self, node: ast.Call) -> None:
        got = classify_sync(node)
        if got is None:
            return
        kind, desc = got
        name = dotted(node.func)
        if kind in ("sync_func", "synchronize"):
            self._flag(
                node,
                f"{desc} inside a loop in a hot module waits for the card "
                "every iteration — record an event and sync once after "
                "the loop",
            )
        elif kind == "item":
            self._flag(
                node,
                ".item() inside a loop in a hot module is a scalar "
                "device->host transfer per iteration",
            )
        elif kind == "to_host":
            self._flag(
                node,
                f"{desc} inside a loop in a hot module copies a tensor to "
                "the host and waits for the stream every iteration — "
                "keep the values on the device, or copy once after the "
                "loop",
            )
        elif kind == "asarray":
            self._flag(
                node,
                f"{name}() on a possibly-device value inside a loop in "
                "a hot module forces a blocking device->host copy each "
                "iteration",
            )
        elif kind == "cast":
            self._flag(
                node,
                f"{name}() wrapped around a torch call inside a loop "
                "is a per-iteration device sync — keep the reduction on "
                "device and convert once after the loop",
            )


# --------------------------------------------------------------------------
# R3 — capture escape


def _is_graph_capture(expr: ast.AST) -> bool:
    """``torch.cuda.graph(g)`` (the capture context manager)."""
    return isinstance(expr, ast.Call) and dotted(expr.func) in (
        "torch.cuda.graph",
        "cuda.graph",
    )


def _own_nodes(fn: ast.AST):
    """Every node of a def's body outside its nested defs and lambdas
    (those are visited as functions of their own)."""
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


class _R3(ast.NodeVisitor):
    def __init__(self) -> None:
        self.findings: List[Tuple[int, int, str]] = []

    def run(self, tree: ast.Module) -> None:
        compiled_names: Set[str] = set()
        for node in ast.walk(tree):
            call = _compile_call_of(node)
            if (
                call is not None
                and dotted(call.func) not in _PARTIAL_NAMES
                and call.args
                and isinstance(call.args[0], ast.Name)
            ):
                compiled_names.add(call.args[0].id)
        for node in ast.walk(tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if (
                function_compile_mode(node) is not None
                or node.name in compiled_names
            ):
                self._scan(
                    node, node.body, f"compiled function '{node.name}'",
                    "a compiled function breaks its graph at a Python side "
                    "effect and may bake the stored value — return it "
                    "instead",
                )
            for sub in _own_nodes(node):
                if isinstance(sub, ast.With) and any(
                    _is_graph_capture(item.context_expr)
                    for item in sub.items
                ):
                    self._scan(
                        node, sub.body,
                        f"the CUDA graph capture in '{node.name}'",
                        "a replay re-runs the captured kernels but never "
                        "this Python statement — do it outside the capture",
                    )

    def _scan(self, fn: ast.AST, body: List[ast.stmt], where: str,
              why: str) -> None:
        globals_declared: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Global):
                globals_declared.update(node.names)
        for stmt in body:
            for node in ast.walk(stmt):
                if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                    targets = (
                        node.targets
                        if isinstance(node, ast.Assign)
                        else [node.target]
                    )
                    for t in targets:
                        if (
                            isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"
                        ):
                            self.findings.append(
                                (
                                    t.lineno,
                                    t.col_offset,
                                    f"store to self.{t.attr} inside "
                                    f"{where}: {why}",
                                )
                            )
                        elif (
                            isinstance(t, ast.Name)
                            and t.id in globals_declared
                        ):
                            self.findings.append(
                                (
                                    t.lineno,
                                    t.col_offset,
                                    f"store to global '{t.id}' inside "
                                    f"{where}: {why}",
                                )
                            )
                elif isinstance(node, ast.Call):
                    name = dotted(node.func)
                    if name in ("threading.Thread", "Thread"):
                        self.findings.append(
                            (
                                node.lineno,
                                node.col_offset,
                                f"threading.Thread created inside {where}: "
                                "work handed to another thread escapes "
                                "the capture — spawn threads outside it",
                            )
                        )


# --------------------------------------------------------------------------
# R4 — lock discipline in thread targets

_LOCK_CTORS = {
    "threading.Lock",
    "threading.RLock",
    "threading.Condition",
    "Lock",
    "RLock",
    "Condition",
}
_MUTABLE_CTORS = {
    "list",
    "dict",
    "set",
    "collections.defaultdict",
    "defaultdict",
    "collections.deque",
    "deque",
    "collections.Counter",
    "Counter",
}
_MUTATORS = {
    "append",
    "extend",
    "insert",
    "add",
    "update",
    "remove",
    "discard",
    "pop",
    "popitem",
    "popleft",
    "appendleft",
    "clear",
    "setdefault",
}


class _R4:
    def __init__(self) -> None:
        self.findings: List[Tuple[int, int, str]] = []

    def run(self, tree: ast.Module) -> None:
        module_locks: Set[str] = set()
        lock_attrs: Set[str] = set()
        module_mutables: Set[str] = set()
        module_names: Set[str] = set()
        funcs: Dict[str, ast.FunctionDef] = {}

        for node in tree.body:
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if not isinstance(t, ast.Name):
                        continue
                    module_names.add(t.id)
                    val = node.value
                    vname = dotted(val.func) if isinstance(val, ast.Call) else None
                    if vname in _LOCK_CTORS:
                        module_locks.add(t.id)
                    elif isinstance(val, (ast.List, ast.Dict, ast.Set)) or (
                        vname in _MUTABLE_CTORS
                    ):
                        module_mutables.add(t.id)

        for node in ast.walk(tree):
            if isinstance(node, ast.FunctionDef):
                funcs[node.name] = node
            elif isinstance(node, ast.Assign):
                # self._lock = threading.Lock() anywhere in the module
                for t in node.targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                        and isinstance(node.value, ast.Call)
                        and dotted(node.value.func) in _LOCK_CTORS
                    ):
                        lock_attrs.add(t.attr)
            elif isinstance(node, ast.Global):
                # a module-level name rebound via `global` is mutable state
                # even when it's a plain scalar counter
                for name in node.names:
                    if name in module_names:
                        module_mutables.add(name)

        targets = self._thread_targets(tree)
        for tname in targets:
            fn = funcs.get(tname)
            if fn is not None:
                self._scan_target(
                    fn, module_mutables, module_locks, lock_attrs
                )

    def _thread_targets(self, tree: ast.Module) -> Set[str]:
        out: Set[str] = set()
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            if dotted(node.func) not in ("threading.Thread", "Thread"):
                continue
            for kw in node.keywords:
                if kw.arg != "target":
                    continue
                if isinstance(kw.value, ast.Name):
                    out.add(kw.value.id)
                elif isinstance(kw.value, ast.Attribute):
                    out.add(kw.value.attr)  # self._work -> method name
        return out

    def _scan_target(
        self,
        fn: ast.FunctionDef,
        mutables: Set[str],
        locks: Set[str],
        lock_attrs: Set[str],
    ) -> None:
        globals_declared: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Global):
                globals_declared.update(node.names)

        def held(expr: ast.AST) -> bool:
            if isinstance(expr, ast.Name) and expr.id in locks:
                return True
            if isinstance(expr, ast.Attribute) and expr.attr in lock_attrs:
                return True
            return False

        findings = self.findings

        def flag(node: ast.AST, what: str) -> None:
            findings.append(
                (
                    node.lineno,
                    node.col_offset,
                    f"thread target '{fn.name}' mutates module state "
                    f"{what} without holding a module Lock/Condition — "
                    "wrap the mutation in `with <lock>:`",
                )
            )

        def walk(node: ast.AST, locked: bool) -> None:
            if isinstance(node, ast.With):
                now_locked = locked or any(
                    held(item.context_expr) for item in node.items
                )
                for child in node.body:
                    walk(child, now_locked)
                return
            if not locked:
                if isinstance(node, (ast.Assign, ast.AugAssign)):
                    targets = (
                        node.targets
                        if isinstance(node, ast.Assign)
                        else [node.target]
                    )
                    for t in targets:
                        if (
                            isinstance(t, ast.Name)
                            and t.id in mutables
                            and t.id in globals_declared
                        ):
                            flag(t, f"'{t.id}'")
                        elif isinstance(t, ast.Subscript):
                            root = t.value
                            if (
                                isinstance(root, ast.Name)
                                and root.id in mutables
                            ):
                                flag(t, f"'{root.id}[...]'")
                elif isinstance(node, ast.Call):
                    f = node.func
                    if (
                        isinstance(f, ast.Attribute)
                        and f.attr in _MUTATORS
                        and isinstance(f.value, ast.Name)
                        and f.value.id in mutables
                    ):
                        flag(node, f"'{f.value.id}.{f.attr}()'")
            for child in ast.iter_child_nodes(node):
                walk(child, locked)

        for stmt in fn.body:
            walk(stmt, False)


# --------------------------------------------------------------------------
# R5 — swallowed exceptions

_LOGGY_PREFIXES = ("logging.", "logger.", "log.", "self.logger.", "self.log.")
_LOGGY_EXACT = {
    "warnings.warn",
    "traceback.print_exc",
    "traceback.print_exception",
    "print",
}


def _handler_is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:  # bare except
        return True
    if isinstance(t, ast.Name) and t.id == "Exception":
        return True
    if isinstance(t, ast.Tuple):
        return any(
            isinstance(el, ast.Name) and el.id == "Exception" for el in t.elts
        )
    return False


def _body_handles(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            name = dotted(node.func)
            if name is None:
                continue
            if name in _LOGGY_EXACT or name.startswith(_LOGGY_PREFIXES):
                return True
            # logging.getLogger(...).warning(...) style chains
            if isinstance(node.func, ast.Attribute) and node.func.attr in (
                "exception",
                "warning",
                "error",
                "critical",
            ):
                return True
    return False


class _R5(ast.NodeVisitor):
    def __init__(self) -> None:
        self.findings: List[Tuple[int, int, str]] = []

    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        if _handler_is_broad(node) and not _body_handles(node):
            what = "bare except" if node.type is None else "except Exception"
            self.findings.append(
                (
                    node.lineno,
                    node.col_offset,
                    f"{what} swallows errors silently — catch the specific "
                    "exception types, and log or re-raise",
                )
            )
        self.generic_visit(node)


# --------------------------------------------------------------------------
# R6 — stats mutation discipline (telemetry metrics facade)

#: ``X.stats.<method>(...)`` calls that mutate the mapping in place;
#: facade methods (inc/put/observe/ensure/merge/restore/fork) are the
#: sanctioned mutation surface and are not listed.
_R6_MUTATING_METHODS = {"update", "clear", "setdefault", "pop", "popitem"}


def _is_stats_base(node: ast.AST) -> bool:
    """True for the expressions R6 guards: an attribute named ``stats``
    (``ctx.stats``, ``self.stats``, ``rdv.stats``) or the bare parameter
    name ``stats`` the resilience/mesh helpers receive."""
    if isinstance(node, ast.Attribute) and node.attr == "stats":
        return True
    return isinstance(node, ast.Name) and node.id == "stats"


class _R6(ast.NodeVisitor):
    """Direct mutation of a stats mapping: subscript assignment /
    augmented assignment, or an in-place-mutating dict method call.
    Reads are fine; the telemetry facade methods are fine.  The rule is
    skipped inside ``telemetry/`` itself (the facade's own home)."""

    def __init__(self) -> None:
        self.findings: List[Tuple[int, int, str]] = []

    def _flag(self, node: ast.AST, what: str) -> None:
        self.findings.append(
            (
                node.lineno,
                node.col_offset,
                f"{what} mutates a stats dict directly — an unlocked "
                "read-modify-write loses updates when threads race; "
                "route it through the telemetry metrics facade "
                "(stats.inc/put/observe/ensure/merge)",
            )
        )

    def _check_target(self, target: ast.AST, node: ast.AST, what: str):
        # Only the assigned-to expression itself counts: recurse through
        # tuple/list/starred unpacking structure, then test whether the
        # leaf subscript's VALUE chain bottoms out at a stats base
        # (``ctx.stats["a"] = v``, ``ctx.stats["a"]["b"] = v``).  A
        # stats READ in the slice of an unrelated target
        # (``cache[ctx.stats["x"]] = v``) mutates ``cache``, not stats.
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._check_target(elt, node, what)
            return
        if isinstance(target, ast.Starred):
            self._check_target(target.value, node, what)
            return
        if isinstance(target, ast.Subscript):
            base = target.value
            while isinstance(base, ast.Subscript):
                base = base.value
            if _is_stats_base(base):
                self._flag(node, what)

    def visit_Assign(self, node: ast.Assign) -> None:
        for target in node.targets:
            self._check_target(target, node, "subscript assignment")
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_target(node.target, node, "augmented assignment")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if (
            isinstance(f, ast.Attribute)
            and f.attr in _R6_MUTATING_METHODS
            and _is_stats_base(f.value)
        ):
            self._flag(node, f".stats.{f.attr}() call")
        self.generic_visit(node)


def _r6_exempt(relpath: str) -> bool:
    """telemetry/ owns the facade; its internals mutate the underlying
    dict under the registry lock by design."""
    return "telemetry" in relpath.replace("\\", "/").split("/")


# --------------------------------------------------------------------------
# suppression comments

_SUPPRESS_RE = re.compile(
    r"#\s*torchlint:\s*ignore\[([A-Za-z0-9_,\s]*)\]\s*(.*)$"
)


@dataclass
class _Suppression:
    line: int
    rules: Set[str]
    reason: str
    standalone: bool  # comment-only line: applies to the next line too


def scan_suppressions(
    source: str,
) -> Tuple[List[_Suppression], List[Tuple[int, int, str]]]:
    """All torchlint suppression comments plus SUP findings for malformed
    ones (empty rule list or missing reason)."""
    sups: List[_Suppression] = []
    bad: List[Tuple[int, int, str]] = []
    try:
        tokens = tokenize.generate_tokens(StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _SUPPRESS_RE.search(tok.string)
            if m is None:
                # only comments that *open with* an attempted directive are
                # malformed; prose mentioning the directive syntax is fine
                if re.match(r"#+\s*torchlint\s*:", tok.string):
                    bad.append(
                        (
                            tok.start[0],
                            tok.start[1],
                            "unrecognized torchlint marker; expected "
                            "'# torchlint: ignore[RULE] reason'",
                        )
                    )
                continue
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            reason = m.group(2).strip()
            line_text = tok.line.strip()
            standalone = line_text.startswith("#")
            if not rules:
                bad.append(
                    (
                        tok.start[0],
                        tok.start[1],
                        "suppression names no rule: use "
                        "'# torchlint: ignore[R2] reason'",
                    )
                )
                continue
            unknown = rules - set(RULE_DOCS)
            if unknown:
                bad.append(
                    (
                        tok.start[0],
                        tok.start[1],
                        f"suppression names unknown rule(s) "
                        f"{sorted(unknown)}",
                    )
                )
                continue
            if not reason:
                bad.append(
                    (
                        tok.start[0],
                        tok.start[1],
                        f"suppression of {sorted(rules)} lacks the "
                        "mandatory reason — say why the finding is safe",
                    )
                )
                continue
            sups.append(_Suppression(tok.start[0], rules, reason, standalone))
    except tokenize.TokenError:
        pass  # the ast parse will report the syntax problem
    return sups, bad


# --------------------------------------------------------------------------
# per-file driver


@dataclass
class FileReport:
    path: str
    findings: List[Finding] = field(default_factory=list)
    suppressed: List[Finding] = field(default_factory=list)
    #: rules this scan actually executed against the file (per-file
    #: rules that applied, plus every cross-module pass when the
    #: whole-program driver ran) — the gate asserts registry parity on
    #: this set, so a rule silently dropping out of the default config
    #: is a test failure, not a quiet coverage loss
    checked: Set[str] = field(default_factory=set)


@dataclass
class FileAnalysis:
    """One file's parse + per-file raw findings, before suppression
    matching.  The whole-program pass (:mod:`.project`) reuses the
    parsed ``tree`` and the scanned suppressions, appends its
    cross-module raw findings, and finalizes — so each module is parsed
    exactly once no matter how many passes run over it."""

    path: str
    source: str
    tree: Optional[ast.Module]  # None on syntax error
    hot: bool
    #: (rule, line, col, message) from the per-file rules
    raw: List[Tuple[str, int, int, str]] = field(default_factory=list)
    sups: List["_Suppression"] = field(default_factory=list)
    bad_sups: List[Tuple[int, int, str]] = field(default_factory=list)
    #: rules whose absence of findings makes a marker provably stale
    checked: Set[str] = field(default_factory=set)
    #: set on syntax error; finalize short-circuits to this
    parse_finding: Optional[Finding] = None


def analyze_file(
    source: str,
    relpath: str,
    config: TorchlintConfig,
    hot: Optional[bool] = None,
    tree: Optional[ast.Module] = None,
) -> FileAnalysis:
    """Parses (or reuses ``tree``) and runs the per-file rules, returning
    the raw, un-suppressed analysis.  ``hot`` overrides the config's
    hot-module glob match (fixture tests exercise R2 on paths outside
    the configured globs)."""
    is_hot = config.is_hot(relpath) if hot is None else hot
    fa = FileAnalysis(path=relpath, source=source, tree=tree, hot=is_hot)
    if fa.tree is None:
        try:
            fa.tree = ast.parse(source)
        except SyntaxError as e:
            fa.parse_finding = Finding(
                relpath, e.lineno or 1, 0, PARSE_RULE,
                f"syntax error: {e.msg}",
            )
            return fa

    if "R1" in config.rules:
        r1 = _R1()
        r1.collect(fa.tree)
        r1.visit(fa.tree)
        fa.raw += [("R1", *f) for f in r1.findings]
    if "R2" in config.rules and is_hot:
        r2 = _R2()
        r2.visit(fa.tree)
        fa.raw += [("R2", *f) for f in r2.findings]
    if "R3" in config.rules:
        r3 = _R3()
        r3.run(fa.tree)
        fa.raw += [("R3", *f) for f in r3.findings]
    if "R4" in config.rules:
        r4 = _R4()
        r4.run(fa.tree)
        fa.raw += [("R4", *f) for f in r4.findings]
    if "R5" in config.rules:
        r5 = _R5()
        r5.visit(fa.tree)
        fa.raw += [("R5", *f) for f in r5.findings]
    if "R6" in config.rules and not _r6_exempt(relpath):
        r6 = _R6()
        r6.visit(fa.tree)
        fa.raw += [("R6", *f) for f in r6.findings]

    fa.sups, fa.bad_sups = scan_suppressions(source)
    # Unused-suppression eligibility: only rules this scan actually
    # executed count (R2 is skipped entirely in non-hot files, so its
    # markers can't be judged there; cross-module rule markers are only
    # judged when the whole-program pass runs and extends this set).
    fa.checked = {r for r in config.rules if r in ("R1", "R3", "R4", "R5")}
    if "R2" in config.rules and is_hot:
        fa.checked.add("R2")
    if "R6" in config.rules and not _r6_exempt(relpath):
        fa.checked.add("R6")
    return fa


def finalize_report(
    fa: FileAnalysis,
    extra_raw: Sequence[Tuple[str, int, int, str]] = (),
    extra_checked: Sequence[str] = (),
) -> FileReport:
    """Matches raw findings (per-file + ``extra_raw`` from cross-module
    passes) against the file's suppressions, and reports stale markers
    for every rule in ``checked`` ∪ ``extra_checked``."""
    report = FileReport(
        path=fa.path, checked=set(fa.checked) | set(extra_checked)
    )
    if fa.parse_finding is not None:
        report.findings.append(fa.parse_finding)
        return report

    by_line: Dict[int, List[_Suppression]] = {}
    for s in fa.sups:
        by_line.setdefault(s.line, []).append(s)
        if s.standalone:
            by_line.setdefault(s.line + 1, []).append(s)

    raw = list(fa.raw) + list(extra_raw)
    used: Set[Tuple[int, str]] = set()  # (id(suppression), rule) pairs
    for rule, line, col, msg in sorted(raw, key=lambda f: (f[1], f[2], f[0])):
        finding = Finding(fa.path, line, col, rule, msg)
        matching = [s for s in by_line.get(line, ()) if rule in s.rules]
        if matching:
            for s in matching:
                used.add((id(s), rule))
            report.suppressed.append(finding)
        else:
            report.findings.append(finding)

    # Unused-suppression detection: a well-formed marker naming a rule
    # that produced NO finding on its line(s) is stale — the hazard it
    # justified is gone (or moved), and a stale marker left behind would
    # silently swallow the next, different finding at that line.
    checked = set(fa.checked) | set(extra_checked)
    for s in fa.sups:
        stale = sorted(
            r for r in s.rules if r in checked and (id(s), r) not in used
        )
        if stale:
            report.findings.append(
                Finding(
                    fa.path,
                    s.line,
                    0,
                    SUPPRESSION_RULE,
                    f"unused suppression: no {', '.join(stale)} finding on "
                    "this line — the justified hazard is gone; remove the "
                    "stale '# torchlint: ignore' marker",
                )
            )

    for line, col, msg in fa.bad_sups:
        report.findings.append(
            Finding(fa.path, line, col, SUPPRESSION_RULE, msg)
        )
    report.findings.sort(key=lambda f: (f.line, f.col, f.rule))
    return report


def lint_source(
    source: str,
    relpath: str,
    config: TorchlintConfig,
    hot: Optional[bool] = None,
) -> FileReport:
    """Lints one file's source with the per-file rules (no cross-module
    analysis; see :func:`sboxgates_tpu_torch.analysis.project.lint_project`)."""
    return finalize_report(analyze_file(source, relpath, config, hot=hot))
