"""Whole-program torchlint: the cross-module rules R1x / R2x / R4x.

The per-file pass (``rules.py``) is structurally blind to three hazard
classes the ROADMAP tracked as known false negatives, all of which need
a project view:

R4x  **lock aliasing + transitive thread reachability.**  A mutation of
     module-level mutable state is racy when any thread-entry root
     (``threading.Thread(target=...)``, the ``ChunkPrefetcher``
     producer, ``dispatch_with_retry`` workers, plus ``[tool.torchlint]
     thread_roots`` extras) reaches the mutating function through the
     call graph with no dominating ``with <lock>`` on the path — where
     the lock may live in another module, be re-exported, or arrive as
     a parameter.  The canonical miss:
     ``ops/combinatorics._native_stream_available`` mutating
     ``_native_ok`` from the prefetch thread via
     ``_work -> _produce_one -> next_chunk``.
R1x  **cross-module scalar-specialization tracking.**  Call sites of
     functions compiled by ``torch.compile`` (decorated, or wrapped at
     module scope) imported from elsewhere that pass a Python scalar
     varying with the enclosing loop — ``torch.compile`` guards on every
     Python scalar, so every distinct value is a recompile.
R2x  **interprocedural host-sync detection.**  A helper that calls
     ``.item()`` / ``.cpu()`` / ``torch.cuda.synchronize()`` (etc.) is
     itself sync-tainted, transitively; calling a tainted helper inside
     a loop in a hot module stalls the dispatch pipeline exactly like
     the direct sync R2 already flags.  A sync carrying a valid
     ``# torchlint: ignore[R2]``/``[R2x]`` suppression is acknowledged
     and does not taint its callers.

Every module is parsed exactly once: the per-file pass and the graph
share the :class:`~.rules.FileAnalysis` cache.  Findings are
deterministic (sorted traversal everywhere) and suppressible with the
existing ``# torchlint: ignore[RULE] reason`` syntax; the
unused-suppression rule judges R1x/R2x/R4x markers only when this pass
actually ran.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .callgraph import ProjectGraph, bind_call_args, build_graph
from .config import TorchlintConfig
from .rules import (
    FileAnalysis,
    FileReport,
    Finding,
    analyze_file,
    dotted,
    finalize_report,
    varying_scalar_message,
)

RawFinding = Tuple[str, int, int, str]  # (rule, line, col, message)


def _short_path(keys: List[str], limit: int = 8) -> str:
    """Human call-path 'a -> b -> c' from function keys, elided when long."""
    names = [k.split(":", 1)[1] for k in keys]
    if len(names) > limit:
        names = names[:3] + ["..."] + names[-(limit - 4):]
    return " -> ".join(names)


# --------------------------------------------------------------------------
# R4x — lock aliasing + transitive thread reachability


def run_r4x(
    graph: ProjectGraph,
    skip_sites: Set[Tuple[str, int]],
) -> Dict[str, List[RawFinding]]:
    """``skip_sites``: (path, line) pairs where the per-file R4 already
    fired (a direct thread-target mutation) — reported once, not twice."""
    out: Dict[str, List[RawFinding]] = {}
    reach = graph.unlocked_reachable()
    for m in sorted(
        graph.mutations,
        key=lambda m: (m.path, m.line, m.col, m.state_name),
    ):
        path_to = reach.get(m.func)
        if path_to is None:
            continue
        if (m.path, m.line) in skip_sites:
            continue
        fi = graph.functions[m.func]
        if graph.stack_holds_lock(fi.module, m.func, m.with_stack):
            continue
        root = path_to[0].split(":", 1)[1]
        via = _short_path(path_to)
        owner = (
            "its own module's state"
            if m.state_module == fi.module
            else f"state owned by '{m.state_module}'"
        )
        out.setdefault(m.path, []).append(
            (
                "R4x",
                m.line,
                m.col,
                f"module state {m.what} ({owner}) is mutated on an "
                f"unlocked path reachable from thread entry '{root}' "
                f"(via {via}) — guard the mutation with the owning "
                "module's Lock (imported/aliased/parameter locks count)",
            )
        )
    return out


# --------------------------------------------------------------------------
# R1x — cross-module static-arg tracking


def run_r1x(graph: ProjectGraph) -> Dict[str, List[RawFinding]]:
    out: Dict[str, List[RawFinding]] = {}
    seen: Set[Tuple[str, int, int, str]] = set()
    for e in sorted(
        graph.edges,
        key=lambda e: (e.path, e.line, e.col, e.caller, e.callee),
    ):
        if e.call is None or e.via != "direct" or not e.loop_vars:
            continue
        caller = graph.functions.get(e.caller)
        if caller is None:
            continue
        name = _call_name(e.call)
        if name is None:
            continue
        callee = graph.specializing_callee(caller.module, name)
        if callee is None:
            continue
        # The per-file R1 already checks bare-name calls of functions
        # compile-DECORATED in the same module; don't double-report those.
        if (
            callee.module == caller.module
            and callee.compiled is not None
            and isinstance(e.call.func, ast.Name)
        ):
            continue
        loop_vars = set(e.loop_vars)
        for pname, expr in bind_call_args(callee, e.call):
            if not (_names_in(expr) & loop_vars):
                continue
            key = (e.path, expr.lineno, expr.col_offset, pname)
            if key in seen:
                continue
            seen.add(key)
            out.setdefault(e.path, []).append(
                (
                    "R1x",
                    expr.lineno,
                    expr.col_offset,
                    varying_scalar_message(
                        pname,
                        f"compiled '{callee.qualname}' "
                        f"(from {callee.module})",
                    ),
                )
            )
    return out


def _call_name(call: ast.Call) -> Optional[str]:
    return dotted(call.func)


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


# --------------------------------------------------------------------------
# R2x — interprocedural host-sync detection


def run_r2x(
    graph: ProjectGraph,
    hot_paths: Set[str],
    acknowledged: Set[Tuple[str, int]],
) -> Dict[str, List[RawFinding]]:
    """``hot_paths``: relpaths where the loop-call check applies (the
    same hot-module set R2 uses).  ``acknowledged``: sync sites carrying
    a valid R2/R2x suppression — they don't taint."""
    out: Dict[str, List[RawFinding]] = {}
    taint = graph.sync_taint(acknowledged)
    seen: Set[Tuple[str, int, int, str]] = set()
    for e in sorted(
        graph.edges,
        key=lambda e: (e.path, e.line, e.col, e.caller, e.callee),
    ):
        if not e.in_loop or e.path not in hot_paths:
            continue
        witness = taint.get(e.callee)
        if witness is None:
            continue
        callee = graph.functions.get(e.callee)
        if callee is None:
            continue
        if e.callee == e.caller:
            continue  # recursion: the direct sync is already R2's job
        # The direct sync inside THIS function at THIS line is R2's
        # territory; R2x is only about syncs hidden behind a call.
        if witness.func == e.caller and witness.line == e.line:
            continue
        key = (e.path, e.line, e.col, e.callee)
        if key in seen:
            continue
        seen.add(key)
        out.setdefault(e.path, []).append(
            (
                "R2x",
                e.line,
                e.col,
                f"call to '{callee.qualname}' inside a loop in a hot "
                f"module: it transitively performs a host-device sync "
                f"({witness.desc} at {witness.path}:{witness.line}) — "
                "every iteration stalls the dispatch pipeline; batch or "
                "hoist the sync, or suppress with a reason if the sync "
                "is the point",
            )
        )
    return out


# --------------------------------------------------------------------------
# whole-program driver


def _acknowledged_sync_sites(
    analyses: Sequence[FileAnalysis],
) -> Set[Tuple[str, int]]:
    """(path, line) pairs whose line carries a valid R2/R2x suppression
    (standalone markers cover the following line, as in finalize)."""
    ack: Set[Tuple[str, int]] = set()
    for fa in analyses:
        for s in fa.sups:
            if not (s.rules & {"R2", "R2x"}):
                continue
            ack.add((fa.path, s.line))
            if s.standalone:
                ack.add((fa.path, s.line + 1))
    return ack


def analyze_project(
    analyses: Sequence[FileAnalysis],
    config: TorchlintConfig,
) -> Tuple[List[FileReport], ProjectGraph]:
    """Runs the cross-module rules over pre-analyzed files and returns
    finalized per-file reports plus the resolved graph (for --graph)."""
    trees = {
        fa.path: fa.tree for fa in analyses if fa.tree is not None
    }
    graph = build_graph(
        trees,
        thread_root_config=config.thread_roots,
        jit_root_config=config.jit_roots,
    )

    extra: Dict[str, List[RawFinding]] = {}
    ran: Set[str] = set()
    if "R4x" in config.rules:
        ran.add("R4x")
        skip = {
            (fa.path, line)
            for fa in analyses
            for (rule, line, _c, _m) in fa.raw
            if rule == "R4"
        }
        for path, items in run_r4x(graph, skip).items():
            extra.setdefault(path, []).extend(items)
    if "R1x" in config.rules:
        ran.add("R1x")
        for path, items in run_r1x(graph).items():
            extra.setdefault(path, []).extend(items)
    if "R2x" in config.rules:
        ran.add("R2x")
        hot_paths = {fa.path for fa in analyses if fa.hot}
        ack = _acknowledged_sync_sites(analyses)
        for path, items in run_r2x(graph, hot_paths, ack).items():
            extra.setdefault(path, []).extend(items)
        # A deliberate sync can be acknowledged AT ITS SOURCE with an
        # R2x marker: the taint dies there for every caller.  Emit the
        # acknowledged source as a (suppressed) finding so the marker
        # counts as used instead of being reported stale, and so the
        # baseline documents the acknowledged sync inventory.
        sync_lines: Dict[Tuple[str, int], Tuple[int, str]] = {}
        for s in graph.sync_sites:
            key = (s.path, s.line)
            if key not in sync_lines or (s.col, s.desc) < sync_lines[key]:
                sync_lines[key] = (s.col, s.desc)
        for fa in analyses:
            for sup in fa.sups:
                if "R2x" not in sup.rules:
                    continue
                lines = [sup.line]
                if sup.standalone:
                    lines.append(sup.line + 1)
                for line in lines:
                    hit = sync_lines.get((fa.path, line))
                    if hit is not None:
                        extra.setdefault(fa.path, []).append(
                            (
                                "R2x",
                                line,
                                hit[0],
                                f"deliberate host sync at its source "
                                f"({hit[1]}): acknowledged — callers are "
                                "not sync-tainted by this site",
                            )
                        )
                        break

    # Contract-verification passes (R7/R8/R9): registry drift, bucket
    # discipline, lock ordering.  They share the same graph and the same
    # raw-finding/suppression plumbing as the other x-rules.
    if "R7" in config.rules:
        from .registries import run_r7

        ran.add("R7")
        for path, items in run_r7(graph, config).items():
            extra.setdefault(path, []).extend(items)
    if "R8" in config.rules:
        from .bucketflow import run_r8

        ran.add("R8")
        for path, items in run_r8(graph, config).items():
            extra.setdefault(path, []).extend(items)
    if "R9" in config.rules:
        from .lockorder import run_r9

        ran.add("R9")
        r9_findings, lock_order = run_r9(graph, config)
        for path, items in r9_findings.items():
            extra.setdefault(path, []).extend(items)
        # Stashed for --graph: the resolved lock-order graph rides along
        # with the call graph so the root-coverage gate can read it.
        graph.lock_order = lock_order

    # Protocol/determinism/durability shadows (R10/R11/R12): the static
    # mirrors of the replicated-degradation, bit-identical-resume, and
    # torn-write runtime contracts.
    if "R10" in config.rules:
        from .protocol import run_r10

        ran.add("R10")
        for path, items in run_r10(graph, config).items():
            extra.setdefault(path, []).extend(items)
    if "R11" in config.rules:
        from .determinism import nondet_sites, run_r11

        ran.add("R11")
        ack11: Set[Tuple[str, int]] = set()
        for fa in analyses:
            for s in fa.sups:
                if "R11" not in s.rules:
                    continue
                ack11.add((fa.path, s.line))
                if s.standalone:
                    ack11.add((fa.path, s.line + 1))
        for path, items in run_r11(graph, config, ack11).items():
            extra.setdefault(path, []).extend(items)
        # The R2x acknowledged-source contract, for determinism: a valid
        # R11 marker ON the nondet source kills the taint for every
        # caller, and the source is re-emitted as a suppressed finding
        # so the marker is never stale and the baseline documents the
        # acknowledged-nondeterminism inventory.
        src_lines = nondet_sites(graph, config)
        for fa in analyses:
            for sup in fa.sups:
                if "R11" not in sup.rules:
                    continue
                lines = [sup.line]
                if sup.standalone:
                    lines.append(sup.line + 1)
                for line in lines:
                    hit = src_lines.get((fa.path, line))
                    if hit is not None:
                        extra.setdefault(fa.path, []).append(
                            (
                                "R11",
                                line,
                                hit[0],
                                f"deliberate nondeterminism at its "
                                f"source ({hit[1]}): acknowledged — "
                                "sinks are not tainted by this site",
                            )
                        )
                        break
    if "R12" in config.rules:
        from .durability import run_r12

        ran.add("R12")
        for path, items in run_r12(graph, config).items():
            extra.setdefault(path, []).extend(items)

    # Trust-boundary shadows (R13/R14/R15): the static mirrors of the
    # network tier's auth-before-effect, journal-before-202, and
    # drain-safe-teardown runtime contracts.
    if "R13" in config.rules:
        from .trustflow import run_r13, untrusted_sites

        ran.add("R13")
        ack13: Set[Tuple[str, int]] = set()
        for fa in analyses:
            for s in fa.sups:
                if "R13" not in s.rules:
                    continue
                ack13.add((fa.path, s.line))
                if s.standalone:
                    ack13.add((fa.path, s.line + 1))
        for path, items in run_r13(graph, config, ack13).items():
            extra.setdefault(path, []).extend(items)
        # The R2x/R11 acknowledged-source contract, for request taint:
        # a valid R13 marker ON the untrusted source kills the taint
        # for every consumer, and the source is re-emitted as a
        # suppressed finding so the marker is never stale and the
        # baseline documents the acknowledged-input inventory.
        src13 = untrusted_sites(graph, config)
        for fa in analyses:
            for sup in fa.sups:
                if "R13" not in sup.rules:
                    continue
                lines = [sup.line]
                if sup.standalone:
                    lines.append(sup.line + 1)
                for line in lines:
                    hit = src13.get((fa.path, line))
                    if hit is not None:
                        extra.setdefault(fa.path, []).append(
                            (
                                "R13",
                                line,
                                hit[0],
                                f"deliberate untrusted input at its "
                                f"source ({hit[1]}): acknowledged — "
                                "sinks are not tainted by this site",
                            )
                        )
                        break
    if "R14" in config.rules:
        from .ordering import run_r14

        ran.add("R14")
        for path, items in run_r14(graph, config).items():
            extra.setdefault(path, []).extend(items)
    if "R15" in config.rules:
        from .lifecycle import run_r15

        ran.add("R15")
        for path, items in run_r15(graph, config).items():
            extra.setdefault(path, []).extend(items)

    reports: List[FileReport] = []
    for fa in analyses:
        # Every x-rule that ran is judged for stale markers — including
        # R2x in non-hot files: loop-call findings can't land there, but
        # acknowledged-source entries are emitted wherever a sync site
        # carries a marker, so an R2x marker with no finding under it is
        # genuinely stale (the acknowledged sync is gone) and the
        # inline-ignore inventory must not accrete.
        reports.append(
            finalize_report(fa, extra.get(fa.path, ()), set(ran))
        )
    # Findings about unscanned paths (the torchlint.toml config itself, e.g.
    # a stale thread_roots pin) get a bare report — no inline
    # suppressions to match there.
    covered = {fa.path for fa in analyses}
    for path in sorted(set(extra) - covered):
        rep = FileReport(path=path)
        for rule, line, col, msg in sorted(
            extra[path], key=lambda f: (f[1], f[2], f[0])
        ):
            rep.findings.append(Finding(path, line, col, rule, msg))
        reports.append(rep)
    return reports, graph


def lint_project(
    paths: Optional[List[str]] = None,
    config: Optional[TorchlintConfig] = None,
    return_graph: bool = False,
):
    """Whole-program lint of ``paths`` (default: config paths): per-file
    rules + R1x/R2x/R4x, one parse per module."""
    from .cli import iter_python_files
    from .config import load_config

    if config is None:
        config = load_config(paths[0] if paths else ".")
    scan = paths or config.paths
    analyses: List[FileAnalysis] = []
    for ap, rel in iter_python_files(config.root, scan, config):
        with open(ap, "r", encoding="utf-8") as f:
            source = f.read()
        analyses.append(analyze_file(source, rel, config))
    reports, graph = analyze_project(analyses, config)
    if return_graph:
        return reports, graph
    return reports


def graph_json(
    paths: Optional[List[str]] = None,
    config: Optional[TorchlintConfig] = None,
) -> dict:
    """The resolved call graph + roots as a deterministic JSON dict
    (the ``--graph`` CLI output)."""
    _reports, graph = lint_project(paths, config, return_graph=True)
    return graph_payload(graph)


def graph_payload(graph: ProjectGraph) -> dict:
    """:func:`graph_json` of an already-built graph.  When R9 ran, the
    lock-order graph rides along with per-root transitive acquisitions,
    so the gate can assert every pinned thread root is covered."""
    data = graph.as_json()
    lock_order = getattr(graph, "lock_order", None)
    if lock_order is not None:
        lo = lock_order.as_json()
        lo["root_acquires"] = {
            root: sorted(lock_order.trans_acquires.get(root, ()))
            for root in data["thread_roots"]
        }
        data["lock_order"] = lo
    return data
