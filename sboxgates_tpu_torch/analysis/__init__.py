"""torchlint — PyTorch-aware static analysis for the port.

``python -m sboxgates_tpu_torch.analysis [paths...]`` scans for the
failure modes that silently erase streaming-search throughput on the
card: recompilation hazards (R1), host-device syncs inside hot loops
(R2), capture escapes (R3), lock-discipline violations in thread targets
(R4), and swallowed exceptions (R5).  The whole-program pass
(``whole_program`` in ``[tool.torchlint]``, or ``--whole-program``)
parses every module once, resolves imports into a project symbol table,
builds a call graph with thread-entry and compile-boundary roots, and
runs the cross-module rules: R4x (lock aliasing + transitive thread
reachability), R1x (scalar specialization across modules), R2x
(interprocedural host-sync detection), and the contract passes R7–R15;
``--graph`` dumps the resolved graph as JSON.  Configuration lives in the
``[tool.torchlint]`` table of ``torchlint.toml`` at the project root;
suppressions are inline ``# torchlint: ignore[RULE] reason`` comments
(reason mandatory).  The committed baseline is ``torchlint_baseline.json``.

It is pure stdlib ``ast``: nothing here imports torch, so it runs on any
host.  The runtime complements — :func:`sboxgates_tpu_torch.utils.guards.recompile_guard`
and :func:`sboxgates_tpu_torch.utils.guards.sync_guard` — catch what a
static pass cannot see; the tier-1 gate (tests/test_torch_lint.py) holds
the port's tree at zero unsuppressed findings.
"""

from .config import ALL_RULES, CROSS_RULES, FILE_RULES, TorchlintConfig, load_config
from .rules import RULE_DOCS, FileReport, Finding, lint_source
from .cli import iter_python_files, lint_paths, main
from .project import graph_json, lint_project

__all__ = [
    "ALL_RULES",
    "CROSS_RULES",
    "FILE_RULES",
    "TorchlintConfig",
    "load_config",
    "RULE_DOCS",
    "FileReport",
    "Finding",
    "lint_source",
    "iter_python_files",
    "lint_paths",
    "main",
    "graph_json",
    "lint_project",
]
