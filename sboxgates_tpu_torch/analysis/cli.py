"""``python -m sboxgates_tpu_torch.analysis`` — the torchlint CLI.

Scans the given paths (default: the ``paths`` from ``[tool.torchlint]``),
prints findings in human or JSON form, and exits non-zero when any
unsuppressed finding remains.  ``--write-baseline``/``--baseline`` manage
the committed zero-findings baseline the tier-1 gate compares against.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Iterable, List, Optional

from .config import ALL_RULES, TorchlintConfig, load_config
from .rules import RULE_DOCS, FileReport, Finding, lint_source

BASELINE_SCHEMA = 1


def iter_python_files(root: str, paths: Iterable[str], config: TorchlintConfig):
    """Yields (abspath, relpath) for every .py under the scan paths, in
    sorted order, minus the config's ``exclude`` globs."""
    seen = set()
    for p in paths:
        ap = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isfile(ap):
            cands = [ap]
        else:
            cands = []
            for dirpath, dirnames, filenames in os.walk(ap):
                dirnames.sort()
                dirnames[:] = [d for d in dirnames if d != "__pycache__"]
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        cands.append(os.path.join(dirpath, fn))
        for ap_file in cands:
            rel = os.path.relpath(ap_file, root).replace(os.sep, "/")
            if rel in seen or config.is_excluded(rel):
                continue
            seen.add(rel)
            yield ap_file, rel


def lint_paths(
    paths: Optional[List[str]] = None,
    config: Optional[TorchlintConfig] = None,
) -> List[FileReport]:
    """Library entry point: lint ``paths`` (default from config) and
    return per-file reports.  When the config enables ``whole_program``,
    the cross-module pass (call graph + R1x/R2x/R4x) runs too, sharing
    one parse per module with the per-file rules."""
    if config is None:
        config = load_config(paths[0] if paths else ".")
    if config.whole_program:
        from .project import lint_project

        return lint_project(paths, config)
    scan = paths or config.paths
    reports: List[FileReport] = []
    for ap, rel in iter_python_files(config.root, scan, config):
        with open(ap, "r", encoding="utf-8") as f:
            source = f.read()
        reports.append(lint_source(source, rel, config))
    return reports


def lint_ref(
    ref: str,
    config: TorchlintConfig,
    paths: Optional[List[str]] = None,
    sources_out: Optional[dict] = None,
) -> List[FileReport]:
    """Lints the tree as it exists at git ``ref`` (sources read via
    ``git show``, never touching the working tree), with the SAME
    current configuration — so ``--diff-base`` judges old code by
    today's contracts, which is exactly what an incremental gate wants.
    ``sources_out``, if given, is filled with relpath -> source lines so
    callers need not re-fetch the same blobs from git.  Raises
    ``RuntimeError`` with a one-line message on git failures."""
    import subprocess

    from .project import analyze_project
    from .rules import analyze_file, finalize_report

    proc = subprocess.run(
        ["git", "ls-tree", "-r", "--name-only", ref],
        cwd=config.root,
        capture_output=True,
        text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"cannot list files at {ref!r}: "
            f"{proc.stderr.strip().splitlines()[-1] if proc.stderr.strip() else 'git failed'}"
        )
    # git ls-tree paths are repo-relative: absolute scan specs (which
    # iter_python_files accepts for the working tree) must be
    # relativized against the project root to match anything.
    scan = []
    for p in paths or config.paths:
        if os.path.isabs(p):
            p = os.path.relpath(p, config.root)
        scan.append(os.path.normpath(p).replace(os.sep, "/"))
    wanted = []
    for rel in sorted(proc.stdout.splitlines()):
        if not rel.endswith(".py") or config.is_excluded(rel):
            continue
        if any(
            s in (".", "") or rel == s or rel.startswith(s + "/")
            for s in scan
        ):
            wanted.append(rel)
    analyses = []
    for rel in wanted:
        show = subprocess.run(
            ["git", "show", f"{ref}:{rel}"],
            cwd=config.root,
            capture_output=True,
            text=True,
        )
        if show.returncode != 0:
            continue  # racy rename/submodule edge: treat as absent
        if sources_out is not None:
            sources_out[rel] = show.stdout.splitlines()
        analyses.append(analyze_file(show.stdout, rel, config))
    if config.whole_program:
        reports, _graph = analyze_project(analyses, config)
        return reports
    return [finalize_report(fa) for fa in analyses]


def _finding_keys(reports: List[FileReport], root: str,
                  ref: Optional[str] = None,
                  sources: Optional[dict] = None):
    """Content-keyed finding multiset: (path, rule, stripped source
    line).  Keying on the line TEXT instead of the number keeps
    unrelated edits above a finding from resurrecting it as "new" in
    differential mode.  ``sources`` seeds the relpath -> lines cache
    (lint_ref already fetched the base blobs once)."""
    import subprocess
    from collections import Counter

    sources = {} if sources is None else sources

    def line_text(path: str, line: int) -> str:
        if path not in sources:
            try:
                if ref is None:
                    with open(
                        os.path.join(root, path), "r", encoding="utf-8"
                    ) as f:
                        sources[path] = f.read().splitlines()
                else:
                    proc = subprocess.run(
                        ["git", "show", f"{ref}:{path}"],
                        cwd=root,
                        capture_output=True,
                        text=True,
                    )
                    sources[path] = (
                        proc.stdout.splitlines()
                        if proc.returncode == 0
                        else []
                    )
            except OSError:
                sources[path] = []
        lines = sources[path]
        if 1 <= line <= len(lines):
            return lines[line - 1].strip()
        return ""

    counts: Counter = Counter()
    keyed = []
    for r in reports:
        for f in r.findings:
            key = (f.path, f.rule, line_text(f.path, f.line))
            counts[key] += 1
            keyed.append((f, key))
    return counts, keyed


def _flatten(reports: List[FileReport]):
    findings = [f for r in reports for f in r.findings]
    suppressed = [f for r in reports for f in r.suppressed]
    return findings, suppressed


def _as_payload(reports: List[FileReport]) -> dict:
    findings, suppressed = _flatten(reports)
    return {
        "schema": BASELINE_SCHEMA,
        "files_scanned": len(reports),
        "findings": [f.as_json() for f in findings],
        "suppressed": [f.as_json() for f in suppressed],
    }


def _as_sarif(reports: List[FileReport],
              baseline_keys: frozenset = frozenset()) -> dict:
    """SARIF 2.1.0 view of the unsuppressed findings — the interchange
    format CI diff-annotation tooling consumes.

    ``baseline_keys``: (path, line, rule) triples from the committed
    ``--baseline``.  A finding the baseline already accounts for is
    still emitted (the log stays a complete scan record) but carries a
    ``suppressions`` entry of kind ``external`` (§3.27.23: suppressed
    outside the source, here by the baseline file), so CI annotators
    show only genuinely new results."""
    findings, _ = _flatten(reports)
    return {
        "$schema": "https://json.schemastore.org/sarif-2.1.0.json",
        "version": "2.1.0",
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "torchlint",
                        "rules": [
                            {
                                "id": rid,
                                "shortDescription": {
                                    "text": RULE_DOCS[rid]
                                },
                            }
                            for rid in sorted(RULE_DOCS)
                        ],
                    }
                },
                "results": [
                    {
                        "ruleId": f.rule,
                        "level": "warning",
                        "message": {"text": f.message},
                        "locations": [
                            {
                                "physicalLocation": {
                                    "artifactLocation": {"uri": f.path},
                                    "region": {
                                        "startLine": f.line,
                                        "startColumn": f.col + 1,
                                    },
                                }
                            }
                        ],
                        **(
                            {"suppressions": [{"kind": "external"}]}
                            if (f.path, f.line, f.rule) in baseline_keys
                            else {}
                        ),
                    }
                    for f in sorted(
                        findings,
                        key=lambda f: (f.path, f.line, f.col, f.rule),
                    )
                ],
            }
        ],
    }


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sboxgates_tpu_torch.analysis",
        description="torchlint: PyTorch-aware static analysis for "
        "sboxgates_tpu_torch (recompile hazards, hot-loop syncs, capture "
        "escapes, lock "
        "discipline, swallowed errors)",
    )
    ap.add_argument(
        "paths",
        nargs="*",
        help="files/directories to scan (default: [tool.torchlint] paths)",
    )
    ap.add_argument(
        "--format",
        "-f",
        choices=("human", "json"),
        default="human",
        help="output format",
    )
    ap.add_argument(
        "--rules",
        help="comma-separated rule ids to enable (default: config)",
    )
    ap.add_argument(
        "--baseline",
        metavar="FILE",
        help="compare against a committed baseline: exit 0 iff the "
        "unsuppressed findings exactly match the baseline's",
    )
    ap.add_argument(
        "--write-baseline",
        metavar="FILE",
        help="write the current findings as the new baseline and exit 0",
    )
    ap.add_argument(
        "--diff-base",
        metavar="REF",
        help="differential mode: report only findings introduced "
        "relative to git REF (both trees judged by the CURRENT config; "
        "findings matched by (path, rule, source-line text) so "
        "unrelated edits don't resurrect old ones) — fast incremental "
        "output for local iteration while the tier-1 gate stays on the "
        "zero-findings --baseline",
    )
    ap.add_argument(
        "--list-rules", action="store_true", help="print the rule table"
    )
    wp = ap.add_mutually_exclusive_group()
    wp.add_argument(
        "--whole-program",
        action="store_true",
        default=None,
        help="run the cross-module pass (call graph + R1x/R2x/R4x) even "
        "if [tool.torchlint] whole_program is off",
    )
    wp.add_argument(
        "--no-whole-program",
        action="store_true",
        help="per-file rules only, ignoring [tool.torchlint] whole_program",
    )
    ap.add_argument(
        "--graph",
        action="store_true",
        help="dump the resolved call graph (functions, edges with "
        "lock/loop context, thread and compile roots) as deterministic JSON "
        "and exit",
    )
    ap.add_argument(
        "--sarif",
        metavar="FILE",
        help="also write the unsuppressed findings as SARIF 2.1.0 to "
        "FILE (CI diff annotation), alongside the chosen --format",
    )
    ap.add_argument(
        "--coverage",
        action="store_true",
        help="chaos-coverage report: cross-reference faults.KNOWN_SITES "
        "against the tests' arm()/SBG_FAULTS specs and [tool.torchlint] "
        "chaos_waivers; exit 1 on unexercised sites or stale waivers",
    )
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid in (*ALL_RULES, "COV", "SUP", "ERR"):
            print(f"{rid:4s} {RULE_DOCS[rid]}")
        return 0

    start = args.paths[0] if args.paths else "."
    try:
        config = load_config(start)
    except ValueError as e:
        print(f"torchlint: {e}", file=sys.stderr)
        return 2
    if args.rules:
        wanted = [r.strip() for r in args.rules.split(",") if r.strip()]
        bad = [r for r in wanted if r not in ALL_RULES]
        if bad:
            print(f"torchlint: unknown rule ids {bad}", file=sys.stderr)
            return 2
        config.rules = wanted
    if args.whole_program:
        config.whole_program = True
    elif args.no_whole_program:
        config.whole_program = False

    if args.graph:
        from .project import graph_json

        json.dump(
            graph_json(args.paths or None, config),
            sys.stdout,
            indent=1,
            sort_keys=True,
        )
        print()
        return 0

    if args.coverage:
        from .durability import chaos_coverage
        from .project import lint_project

        config.whole_program = True  # the site registry needs the graph
        _reports, graph = lint_project(
            args.paths or None, config, return_graph=True
        )
        report = chaos_coverage(graph, config)
        if args.format == "json":
            json.dump(report, sys.stdout, indent=1, sort_keys=True)
            print()
        else:
            for name in sorted(report["sites"]):
                s = report["sites"][name]
                if s["armed_by"]:
                    how = f"armed by {', '.join(s['armed_by'])}"
                elif s["waiver"]:
                    how = f"waived: {s['waiver']}"
                else:
                    how = "UNCOVERED"
                print(f"{name:20s} {s['declared']:40s} {how}")
            for w in report["stale_waivers"]:
                print(f"stale waiver: {w}")
            print(
                f"torchlint: {report['armed_total']}/"
                f"{report['declared_total']} fault sites armed, "
                f"{len(report['uncovered'])} uncovered, "
                f"{len(report['stale_waivers'])} stale waiver(s)"
            )
        return 1 if (
            report["uncovered"] or report["stale_waivers"]
        ) else 0

    reports = lint_paths(args.paths or None, config)
    findings, suppressed = _flatten(reports)
    payload = _as_payload(reports)

    # The baseline is read up front: the SARIF export marks
    # baseline-matched results as externally suppressed, so it needs
    # the key set before writing (the exit-code comparison below reuses
    # the same set).
    base_set: Optional[set] = None
    if args.baseline:
        try:
            with open(args.baseline, "r", encoding="utf-8") as f:
                base = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"torchlint: cannot read baseline: {e}", file=sys.stderr)
            return 2
        base_set = {
            (d["path"], d["line"], d["rule"])
            for d in base.get("findings", ())
        }

    if args.sarif:
        with open(args.sarif, "w", encoding="utf-8") as f:
            json.dump(
                _as_sarif(reports, frozenset(base_set or ())),
                f, indent=1, sort_keys=True,
            )
            f.write("\n")

    if args.diff_base:
        base_sources: dict = {}
        try:
            base_reports = lint_ref(
                args.diff_base, config, args.paths or None,
                sources_out=base_sources,
            )
        except RuntimeError as e:
            print(f"torchlint: {e}", file=sys.stderr)
            return 2
        base_counts, _ = _finding_keys(
            base_reports, config.root, ref=args.diff_base,
            sources=base_sources,
        )
        now_counts, keyed = _finding_keys(reports, config.root)
        budget = dict(base_counts)
        new: List[Finding] = []
        for f, key in keyed:
            if budget.get(key, 0) > 0:
                budget[key] -= 1
            else:
                new.append(f)
        new.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
        if args.format == "json":
            json.dump(
                {
                    "diff_base": args.diff_base,
                    "new_findings": [f.as_json() for f in new],
                    "total_findings": len(findings),
                },
                sys.stdout, indent=1, sort_keys=True,
            )
            print()
        else:
            for f in new:
                print(f.render())
            print(
                f"torchlint: {len(new)} finding(s) introduced since "
                f"{args.diff_base} ({len(findings)} total)"
            )
        return 1 if new else 0

    if args.write_baseline:
        with open(args.write_baseline, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
            f.write("\n")
        print(
            f"torchlint: wrote baseline ({len(findings)} findings) to "
            f"{args.write_baseline}"
        )
        return 0

    if args.format == "json":
        json.dump(payload, sys.stdout, indent=1, sort_keys=True)
        print()
    else:
        for f in findings:
            print(f.render())
        print(
            f"torchlint: {len(findings)} finding(s), "
            f"{len(suppressed)} suppressed, "
            f"{len(reports)} file(s) scanned"
        )

    if base_set is not None:
        now_set = {(f.path, f.line, f.rule) for f in findings}
        new = now_set - base_set
        fixed = base_set - now_set
        if new:
            print(
                f"torchlint: {len(new)} finding(s) not in baseline",
                file=sys.stderr,
            )
        if fixed:
            # Exact match, both directions: a fixed-but-not-regenerated
            # baseline entry would silently mask a later regression at the
            # same (path, line, rule).
            print(
                f"torchlint: {len(fixed)} baseline finding(s) no longer "
                "present — regenerate with --write-baseline",
                file=sys.stderr,
            )
        return 1 if (new or fixed) else 0

    return 1 if findings else 0
