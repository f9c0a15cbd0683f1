"""R12: durability discipline + the chaos-coverage report.

**R12.** The torn-write contract says every file the recovery
path may read is produced by ONE idiom: write the full payload to a
``TMP_PREFIX`` temp file, ``fsync`` it, ``os.replace`` it over the
destination, ``fsync`` the directory — all packaged in
``resilience.checkpoint.durable_write_text``.  Until now that was
convention; this pass makes it structural: inside the persistence
modules (``[tool.torchlint] durable_modules``), a truncating ``open``
(``"w"``/``"x"`` modes), a ``json.dump`` to a stream, or a raw
``os.replace`` outside the declared ``durable_helpers`` is a finding.
Append-mode opens stay legal — the journal's fsync'd append protocol
is a different (and valid) durability discipline.

**Chaos coverage.** ``faults.KNOWN_SITES`` declares the crash surface;
the kill matrices only mean something if every declared site is
actually exercised.  :func:`chaos_coverage` cross-references the
declared sites (extracted by the R7 machinery) against a static scan
of ``tests/`` for ``faults.arm(...)`` calls and ``SBG_FAULTS``-style
spec strings, minus reasoned waivers from ``[tool.torchlint]
chaos_waivers`` ("site: reason").  A waiver naming a site that is no
longer declared is itself a finding — the R7 stale-pin contract.
"""

from __future__ import annotations

import ast
import fnmatch
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from .callgraph import ProjectGraph, iter_body_nodes, spec_matches_function
from .config import TorchlintConfig
from .registries import CONFIG_PATH, extract_registries
from .rules import dotted

RawFinding = Tuple[str, int, int, str]

_TRUNCATING = frozenset("wx")


def _tail(name: Optional[str]) -> Optional[str]:
    return name.rsplit(".", 1)[-1] if name else None


def _open_mode(node: ast.Call) -> Optional[str]:
    """The literal mode of an ``open``-family call, if statically known
    (second positional arg or ``mode=`` keyword; default "r")."""
    expr: Optional[ast.AST] = None
    if len(node.args) >= 2:
        expr = node.args[1]
    for kw in node.keywords:
        if kw.arg == "mode":
            expr = kw.value
    if expr is None:
        return "r"
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value
    return None


def run_r12(graph: ProjectGraph,
            config: TorchlintConfig) -> Dict[str, List[RawFinding]]:
    """R12 findings per project-relative path."""
    out: Dict[str, List[RawFinding]] = {}
    helpers = list(config.durable_helpers)
    for fkey in sorted(graph.functions):
        fi = graph.functions[fkey]
        if not config.is_durable(fi.path):
            continue
        if any(spec_matches_function(s, fkey) for s in helpers):
            continue  # the helper IS the sanctioned idiom
        for node in iter_body_nodes(fi.node):
            if not isinstance(node, ast.Call):
                continue
            name = dotted(node.func)
            if name in ("open", "io.open", "os.fdopen"):
                mode = _open_mode(node)
                if mode is not None and any(
                    ch in _TRUNCATING for ch in mode
                ):
                    out.setdefault(fi.path, []).append(
                        (
                            "R12",
                            node.lineno,
                            node.col_offset,
                            f"truncating open(mode={mode!r}) in a "
                            "persistence module bypasses the durable "
                            "helper — a kill mid-write leaves a torn "
                            "file; route through durable_write_text "
                            "(tmp + fsync + atomic replace) or "
                            "acknowledge with ignore[R12] and a reason",
                        )
                    )
            elif name == "json.dump":
                out.setdefault(fi.path, []).append(
                    (
                        "R12",
                        node.lineno,
                        node.col_offset,
                        "json.dump to a stream in a persistence module "
                        "bypasses the durable helper — serialize with "
                        "json.dumps and route through "
                        "durable_write_text, or acknowledge with "
                        "ignore[R12] and a reason",
                    )
                )
            elif name == "os.replace":
                out.setdefault(fi.path, []).append(
                    (
                        "R12",
                        node.lineno,
                        node.col_offset,
                        "raw os.replace in a persistence module — the "
                        "atomic-replace step belongs inside the durable "
                        "helper (which fsyncs payload AND directory); "
                        "route through durable_write_text or "
                        "acknowledge with ignore[R12] and a reason",
                    )
                )
    return out


# --------------------------------------------------------------------------
# chaos coverage


#: One "site[:action][@when]" element of an SBG_FAULTS spec string.
_SPEC_RE = re.compile(
    r"^([a-z_][a-z0-9_.]*)"          # site
    r"(?:@(?:rank|job):[^:]+)?"      # optional @rank:N / @job:ID target
    r":(?:raise|crash|hang)"         # action
    r"(?:@\d+\+?)?$"                 # optional trigger
)


def _sites_in_spec_string(text: str) -> List[str]:
    sites: List[str] = []
    for part in text.split(","):
        m = _SPEC_RE.match(part.strip())
        if m:
            sites.append(m.group(1))
    return sites


def _scan_test_source(src: str, declared: Set[str]) -> Set[str]:
    """Fault sites a test file arms: ``faults.arm("site", ...)`` calls,
    any ``SBG_FAULTS``-shaped spec string constant, and bare string
    constants naming a declared site (parametrized site lists build the
    spec in an f-string the scanner cannot fold).  Bare names count only
    when the file shows real fault plumbing — an ``arm()`` call, a spec
    constant, or a non-docstring ``SBG_FAULTS`` reference — so a site
    name quoted in, say, the coverage gate's own assertions arms
    nothing."""
    try:
        tree = ast.parse(src)
    except SyntaxError:
        return set()
    docstrings: Set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef,
                             ast.AsyncFunctionDef, ast.ClassDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) \
                    and isinstance(body[0].value, ast.Constant) \
                    and isinstance(body[0].value.value, str):
                docstrings.add(id(body[0].value))
    armed: Set[str] = set()
    bare: Set[str] = set()
    plumbed = False
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _call_tail(node) == "arm":
            if node.args and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                armed.add(node.args[0].value.partition("@")[0])
                plumbed = True
        elif isinstance(node, ast.Constant) \
                and isinstance(node.value, str) \
                and id(node) not in docstrings:
            spec_sites = _sites_in_spec_string(node.value)
            if spec_sites:
                armed.update(spec_sites)
                plumbed = True
            if node.value == "SBG_FAULTS":
                plumbed = True
            if node.value in declared:
                bare.add(node.value)
    if plumbed:
        armed |= bare
    return armed


def _call_tail(node: ast.Call) -> Optional[str]:
    """The called name's last part, whatever the receiver: ``arm`` for
    ``faults.arm(...)`` and for ``_faults(pkg).arm(...)`` alike (a test
    that arms both packages' registries picks the module by a call)."""
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    return _tail(dotted(node.func))


def _default_test_sources(config: TorchlintConfig) -> Dict[str, str]:
    """{relpath: source} for every test file under <root>/tests that
    matches ``[tool.torchlint] test_globs``, fixture packs excluded (an
    ``arm()`` in a lint fixture is not a test)."""
    out: Dict[str, str] = {}
    tests_dir = os.path.join(config.root, "tests")
    for dirpath, dirnames, filenames in os.walk(tests_dir):
        dirnames[:] = sorted(
            d for d in dirnames if not d.endswith("analysis_fixtures")
        )
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            full = os.path.join(dirpath, fn)
            rel = os.path.relpath(full, config.root).replace(os.sep, "/")
            if not any(fnmatch.fnmatch(rel, g) for g in config.test_globs):
                continue
            try:
                with open(full, "r", encoding="utf-8") as f:
                    out[rel] = f.read()
            except OSError:
                continue
    return out


def parse_waivers(config: TorchlintConfig
                  ) -> Tuple[Dict[str, str], List[str]]:
    """(site -> reason, malformed entries).  A waiver is "site: reason";
    the reason is mandatory — a bare site name waives nothing."""
    waivers: Dict[str, str] = {}
    malformed: List[str] = []
    for entry in config.chaos_waivers:
        site, sep, reason = entry.partition(":")
        site, reason = site.strip(), reason.strip()
        if not sep or not site or not reason:
            malformed.append(entry)
            continue
        waivers[site] = reason
    return waivers, malformed


def chaos_coverage(
    graph: ProjectGraph,
    config: TorchlintConfig,
    test_sources: Optional[Dict[str, str]] = None,
) -> dict:
    """Cross-reference declared fault sites against armed tests.

    Returns a deterministic report dict; ``uncovered`` and
    ``stale_waivers`` non-empty means the gate fails."""
    declared = extract_registries(graph).fault_sites
    if test_sources is None:
        test_sources = _default_test_sources(config)
    declared_names = set(declared.entries)
    armed_by: Dict[str, List[str]] = {}
    for rel in sorted(test_sources):
        for site in sorted(
            _scan_test_source(test_sources[rel], declared_names)
        ):
            armed_by.setdefault(site, []).append(rel)
    waivers, malformed = parse_waivers(config)

    sites: Dict[str, dict] = {}
    uncovered: List[str] = []
    for name in sorted(declared.entries):
        path, line = declared.entries[name]
        armed = armed_by.get(name, [])
        waiver = waivers.get(name)
        sites[name] = {
            "declared": f"{path}:{line}",
            "armed_by": armed,
            "waiver": waiver,
        }
        if not armed and waiver is None:
            uncovered.append(name)
    stale = sorted(
        s for s in waivers if s not in declared.entries
    ) + sorted(f"(malformed) {e}" for e in malformed)
    return {
        "schema": 1,
        "config": CONFIG_PATH,
        "sites": sites,
        "uncovered": uncovered,
        "stale_waivers": stale,
        "armed_total": sum(
            1 for s in sites.values() if s["armed_by"]
        ),
        "declared_total": len(sites),
    }
