"""The port's static analyzer (``sboxgates_tpu_torch.analysis``) rule by
rule.

Two halves:

* **Parity.**  The JAX-agnostic rules (R4, R5, R6, R4x, R9-R15, COV and the
  suppression machinery) are the JAX package's rules under the port's
  configuration names.  Both analyzers run on the JAX package's own
  fixture trees (``tests/analysis_fixtures``) with the same configuration
  values; the port reads ``# torchlint:`` markers, so its copy of each
  tree has ``jaxlint`` read as ``torchlint``.  Findings must agree on
  ``(rule, path, line, col)`` and on the message once ``jaxlint`` is read
  as ``torchlint`` (``WORDING``).
* **Retargeted rules.**  R1, R1x, R2, R2x, R3, R7 and R8 speak PyTorch;
  each has a violation and a clean case under
  ``tests/torch_analysis_fixtures`` (excluded from both packages' scans),
  plus the analyzer repairs the port's tree needed (each with a fixture
  the JAX analyzer gets wrong).

Fixtures are read as text, never imported.
"""

import dataclasses
import json
import os
import shutil

import pytest

from sboxgates_tpu.analysis import JaxlintConfig
from sboxgates_tpu.analysis import lint_source as jax_lint_source
from sboxgates_tpu.analysis.config import ALL_RULES as JAX_RULES
from sboxgates_tpu.analysis.durability import chaos_coverage as jax_coverage
from sboxgates_tpu.analysis.project import graph_json as jax_graph_json
from sboxgates_tpu.analysis.project import lint_project as jax_lint_project
from sboxgates_tpu_torch.analysis import TorchlintConfig, lint_source
from sboxgates_tpu_torch.analysis.config import ALL_RULES
from sboxgates_tpu_torch.analysis.durability import chaos_coverage
from sboxgates_tpu_torch.analysis.project import graph_json, lint_project
from sboxgates_tpu_torch.analysis.rules import SUPPRESSION_RULE

HERE = os.path.dirname(os.path.abspath(__file__))
JAX_FIXTURES = os.path.join(HERE, "analysis_fixtures")
FIXTURES = os.path.join(HERE, "torch_analysis_fixtures")

#: The JAX tests' rule set for the legacy multi-file packs (R7's pin gate
#: would flag the packs' deliberately unpinned Thread targets).
LEGACY_RULES = [
    r for r in JAX_RULES
    if r not in ("R7", "R8", "R9", "R10", "R11", "R12",
                 "R13", "R14", "R15")
]

#: JAX-agnostic fixture trees -> the configuration values both analyzers
#: run with (the JAX package's test settings for that tree).
PARITY_TREES = {
    "r4_violation.py": None,
    "r4_clean.py": None,
    "r5_violation.py": None,
    "r5_clean.py": None,
    "r6_violation.py": None,
    "r6_clean.py": None,
    "suppressions.py": None,
    "unused_suppression.py": None,
    "unused_clean.py": None,
    "r4x_violation": dict(rules=LEGACY_RULES),
    "r4x_clean": dict(rules=LEGACY_RULES),
    "r9_violation": dict(rules=["R9"], thread_roots=["forward", "backward"]),
    "r9_clean": dict(rules=["R9"], thread_roots=["forward", "also_forward"]),
    "r10_violation": dict(rules=["R10"]),
    "r10_clean": dict(rules=["R10"]),
    "r11_violation": dict(rules=["R11"]),
    "r11_clean": dict(rules=["R11"]),
    "r12_violation": dict(rules=["R12"], durable_modules=["*"]),
    "r12_clean": dict(rules=["R12"], durable_modules=["*"],
                      durable_helpers=["durable_write_text"]),
    "r13_violation": dict(rules=["R13"], handler_modules=["handler.py"]),
    "r13_clean": dict(rules=["R13"], handler_modules=["handler.py"]),
    "r14_violation": dict(rules=["R14"], handler_modules=["handler.py"]),
    "r14_clean": dict(rules=["R14"], handler_modules=["handler.py"]),
    "r15_violation": dict(rules=["R15"]),
    "r15_clean": dict(rules=["R15"]),
    # every pass at once over a multi-module tree
    "r9_violation+all": dict(rules=[r for r in JAX_RULES
                                    if r not in ("R1", "R2", "R3", "R1x",
                                                 "R2x", "R7", "R8")],
                             thread_roots=["forward", "backward"]),
}


#: The JAX package's wording -> the port's: the tool's name, and R14's
#: contract named by what it guards rather than by the change that made it.
WORDING = (("jaxlint", "torchlint"),
           ("(PR 18 contract)", "(the front door's contract)"))


def _as_torch(text: str) -> str:
    for old, new in WORDING:
        text = text.replace(old, new)
    return text


@pytest.fixture(scope="module")
def torch_copies(tmp_path_factory):
    """The JAX fixture trees with their markers read as torchlint's."""
    root = tmp_path_factory.mktemp("torch_copies")
    for name in sorted(os.listdir(JAX_FIXTURES)):
        src = os.path.join(JAX_FIXTURES, name)
        dst = os.path.join(root, name)
        if os.path.isdir(src):
            shutil.copytree(src, dst)
            files = [os.path.join(d, f) for d, _, fs in os.walk(dst)
                     for f in fs]
        else:
            shutil.copy(src, dst)
            files = [dst]
        for f in files:
            if f.endswith(".py"):
                with open(f, encoding="utf-8") as fh:
                    text = fh.read()
                with open(f, "w", encoding="utf-8") as fh:
                    fh.write(_as_torch(text))
    return str(root)


def _keyed(reports, translate):
    out = []
    for r in reports:
        for kind, items in (("finding", r.findings),
                            ("suppressed", r.suppressed)):
            for f in items:
                msg = _as_torch(f.message) if translate else f.message
                out.append((kind, f.rule, r.path, f.line, f.col, msg))
    return sorted(out)


def _configs(kwargs, jax_root, torch_root):
    jcfg = JaxlintConfig(root=jax_root, paths=["."], hot_modules=[],
                         whole_program=True, **kwargs)
    tcfg = TorchlintConfig(**{**dataclasses.asdict(jcfg), "root": torch_root})
    return jcfg, tcfg


@pytest.mark.parametrize("name", sorted(PARITY_TREES))
def test_parity_with_the_jax_analyzer(name, torch_copies):
    kwargs = PARITY_TREES[name]
    tree = name.split("+", 1)[0]
    src = os.path.join(JAX_FIXTURES, tree)
    dst = os.path.join(torch_copies, tree)
    if kwargs is None:
        jcfg = JaxlintConfig()
        tcfg = TorchlintConfig(**dataclasses.asdict(jcfg))
        with open(src, encoding="utf-8") as f:
            jrep = [jax_lint_source(f.read(), tree, jcfg, hot=True)]
        with open(dst, encoding="utf-8") as f:
            trep = [lint_source(f.read(), tree, tcfg, hot=True)]
    else:
        jcfg, tcfg = _configs(dict(kwargs), src, dst)
        jrep = jax_lint_project(config=jcfg)
        trep = lint_project(config=tcfg)
    want = _keyed(jrep, translate=True)
    if "clean" not in tree:
        assert want, "a dirty tree yields findings or suppressions"
    assert _keyed(trep, translate=False) == want


def test_parity_covers_every_jax_agnostic_fixture():
    agnostic = {
        n for n in os.listdir(JAX_FIXTURES)
        if n.startswith(("r4", "r5", "r6", "r9_", "r10", "r11", "r12",
                         "r13", "r14", "r15", "suppressions", "unused_"))
    }
    assert agnostic == {n.split("+", 1)[0] for n in PARITY_TREES}


def test_graph_dump_parity(torch_copies):
    """``--graph`` on a whole-program tree: the same modules, functions,
    edges (with lock and loop context), roots, lock attrs and lock-order
    graph.  The per-function compile field is the port's (``compiled``,
    None here) where the JAX package records jit statics ([] here)."""
    kwargs = dict(rules=["R4x", "R9"], thread_roots=["forward", "backward"])
    jcfg, tcfg = _configs(
        kwargs, os.path.join(JAX_FIXTURES, "r9_violation"),
        os.path.join(torch_copies, "r9_violation"),
    )
    jg = jax_graph_json(None, jcfg)
    tg = graph_json(None, tcfg)
    for fn in jg["functions"].values():
        assert fn.pop("jit_statics") == []
    for fn in tg["functions"].values():
        assert fn.pop("compiled") is None
    assert tg["lock_order"]["root_acquires"]
    assert json.dumps(tg, sort_keys=True) == json.dumps(jg, sort_keys=True)


def test_chaos_coverage_parity():
    """COV over the same declared sites, tests and waivers."""
    tree = os.path.join(JAX_FIXTURES, "r7_violation")
    tests = {
        "tests/test_a.py": 'faults.arm("ckpt.write", "raise")\n',
        "tests/test_b.py": 'SPEC = "ckpt.write:crash@2"\n',
    }
    jcfg, tcfg = _configs(dict(rules=["R7"]), tree, tree)
    jcfg.chaos_waivers = tcfg.chaos_waivers = ["gone.site: removed"]
    _, jgraph = jax_lint_project(config=jcfg, return_graph=True)
    _, tgraph = lint_project(config=tcfg, return_graph=True)
    jrep = jax_coverage(jgraph, jcfg, tests)
    trep = chaos_coverage(tgraph, tcfg, tests)
    assert jrep.pop("config") == "pyproject.toml"
    assert trep.pop("config") == "torchlint.toml"
    assert trep == jrep
    assert trep["stale_waivers"] == ["gone.site"]


def test_rule_ids_are_the_jax_packages():
    assert ALL_RULES == JAX_RULES


# -- retargeted per-file rules ------------------------------------------


def lint_fixture(name, **cfg):
    with open(os.path.join(FIXTURES, name), encoding="utf-8") as f:
        source = f.read()
    return lint_source(source, name, TorchlintConfig(**cfg), hot=True)


def found(report):
    return [(f.rule, f.line) for f in report.findings]


VIOLATIONS = {
    "r1_violation.py": [("R1", 21), ("R1", 28), ("R1", 35), ("R1", 41)],
    "r2_violation.py": [("R2", 10), ("R2", 11), ("R2", 12), ("R2", 13),
                        ("R2", 14), ("R2", 16), ("R2", 17), ("R2", 24),
                        ("R2", 25)],
    "r3_violation.py": [("R3", 14), ("R3", 21), ("R3", 22), ("R3", 28)],
}


@pytest.mark.parametrize("name,expected", sorted(VIOLATIONS.items()))
def test_retargeted_violation_fixture_exact_findings(name, expected):
    assert found(lint_fixture(name)) == expected


@pytest.mark.parametrize("name", ["r1_clean.py", "r2_clean.py",
                                  "r3_clean.py"])
def test_retargeted_clean_twin_scans_empty(name):
    report = lint_fixture(name)
    assert found(report) == []
    assert report.suppressed == []


def test_r1_messages_name_the_compile_hazard():
    msgs = {f.line: f.message for f in lint_fixture("r1_violation.py").findings}
    assert "torch.compile/torch.jit" in msgs[21] and "hoist" in msgs[21]
    assert "Python scalar argument 'k'" in msgs[35]
    assert "dynamic=True" in msgs[35]
    assert "'shift_c'" in msgs[41]


def test_r2_names_each_torch_sync():
    msgs = [f.message for f in lint_fixture("r2_violation.py").findings]
    for sync in (".item()", ".cpu()", ".tolist()", "np.asarray()",
                 "torch.cuda.synchronize()", "int() wrapped around a torch",
                 ".synchronize()", "bool() wrapped around a torch",
                 ".numpy()"):
        assert any(sync in m for m in msgs), sync
    assert all("inside a loop" in m for m in msgs)


def test_r2_requires_hot_module():
    with open(os.path.join(FIXTURES, "r2_violation.py"),
              encoding="utf-8") as f:
        source = f.read()
    cold = TorchlintConfig(hot_modules=["somewhere_else/*"])
    assert found(lint_source(source, "r2_violation.py", cold)) == []
    hot = TorchlintConfig(hot_modules=["r2_*.py"])
    assert len(found(lint_source(source, "r2_violation.py", hot))) == 9


def test_r3_messages_say_why_the_store_escapes():
    msgs = {f.line: f.message for f in lint_fixture("r3_violation.py").findings}
    assert "CUDA graph capture" in msgs[14] and "replay" in msgs[14]
    assert "compiled function 'step'" in msgs[21]
    assert "threading.Thread" in msgs[22]
    assert "compiled function 'body'" in msgs[28]


def test_jax_markers_are_not_the_ports():
    """The port reads ``# torchlint:`` markers only: a ``# jaxlint:``
    marker suppresses nothing here, and a malformed torchlint marker is a
    SUP finding."""
    src = (
        "def f(xs):\n"
        "    for x in xs:\n"
        "        # jaxlint: ignore[R2] verdict pull\n"
        "        x.item()\n"
        "        # torchlint: ignore[R2]\n"
        "        x.item()\n"
        "        # torchlint: ignore[R2] verdict pull\n"
        "        x.item()\n"
    )
    report = lint_source(src, "hot.py", TorchlintConfig(), hot=True)
    assert found(report) == [("R2", 4), (SUPPRESSION_RULE, 5), ("R2", 6)]
    assert [(f.rule, f.line) for f in report.suppressed] == [("R2", 8)]


def test_syntax_error_reported_not_raised():
    report = lint_source("def broken(:\n", "bad.py", TorchlintConfig())
    assert [f.rule for f in report.findings] == ["ERR"]


# -- retargeted cross-module rules ----------------------------------------


def lint_pack(name, **cfg):
    config = TorchlintConfig(root=os.path.join(FIXTURES, name),
                             paths=["."], whole_program=True, **cfg)
    return lint_project(config=config)


def pack_found(reports):
    return sorted((f.rule, r.path, f.line) for r in reports for f in r.findings)


R7_CFG = dict(rules=["R7"], dispatch_modules=["search/*", "ops/*"],
              kernel_wrappers=["ops/*"])

#: pack -> (config, exact sorted (rule, file, line)).  Each clean twin runs
#: under its dirty pack's config unless CLEAN_PACKS says otherwise.
PACKS = {
    "r1x_violation": (
        dict(rules=["R1x"], hot_modules=[]),
        [("R1x", "driver.py", 7), ("R1x", "driver.py", 8),
         ("R1x", "driver.py", 10)],
    ),
    "r2x_violation": (
        dict(rules=["R2", "R2x"], hot_modules=["*hot*"]),
        [("R2x", "hot_driver.py", 8), ("R2x", "hot_driver.py", 9)],
    ),
    "r7_violation": (
        dict(R7_CFG, thread_roots=["gone"]),
        [
            ("R7", "_kernels.py", 4),          # dead CUDA entry point
            ("R7", "search/driver.py", 11),    # entry reached past ops/
            ("R7", "search/driver.py", 19),    # unpinned thread entry
            ("R7", "torchlint.toml", 1),       # stale thread pin
        ],
    ),
    "r8_violation": (
        dict(rules=["R8"], dispatch_modules=["*"]),
        [("R8", "driver.py", 10), ("R8", "driver.py", 16),
         ("R8", "driver.py", 21)],
    ),
}

CLEAN_PACKS = {
    "r1x_clean": PACKS["r1x_violation"][0],
    "r2x_clean": PACKS["r2x_violation"][0],
    "r7_clean": dict(R7_CFG, thread_roots=["work"]),
    "r8_clean": PACKS["r8_violation"][0],
    "r9_typed_clean": dict(rules=["R9"],
                           thread_roots=["Timer.observe", "Registry.observe"]),
}


@pytest.mark.parametrize("name", sorted(PACKS))
def test_retargeted_violation_pack_exact_findings(name):
    cfg, expected = PACKS[name]
    assert pack_found(lint_pack(name, **cfg)) == expected


@pytest.mark.parametrize("name", sorted(CLEAN_PACKS))
def test_retargeted_clean_pack_scans_empty(name):
    reports = lint_pack(name, **CLEAN_PACKS[name])
    assert pack_found(reports) == []


def test_r1x_message_names_the_compiled_callee():
    msgs = [f.message for r in lint_pack("r1x_violation", **PACKS["r1x_violation"][0])
            for f in r.findings]
    assert any("compiled 'scale' (from compiled)" in m for m in msgs)
    assert any("argument 's' of compiled 'shift'" in m for m in msgs)


def test_r2x_message_names_the_torch_witness():
    msgs = [f.message for r in lint_pack("r2x_violation", **PACKS["r2x_violation"][0])
            for f in r.findings]
    assert any(".item() at helpers.py:6" in m for m in msgs)
    assert any("torch.cuda.synchronize() at helpers.py:10" in m for m in msgs)


def test_r2x_acknowledged_source_is_used_not_stale():
    reports = lint_pack("r2x_clean", **CLEAN_PACKS["r2x_clean"])
    assert [(f.rule, r.path, f.line) for r in reports for f in r.suppressed] \
        == [("R2x", "helpers.py", 8)]


def test_r2x_external_module_call_is_not_a_project_method():
    """``torch.from_numpy`` in the hot loop is torch's, never the
    project's ``Table.from_numpy``: a call on an imported library module
    gets no name-based edge (the port's tree had two such false R2x
    findings through ``State.from_numpy``)."""
    cfg = TorchlintConfig(root=os.path.join(FIXTURES, "r2x_clean"),
                          paths=["."], whole_program=True,
                          **CLEAN_PACKS["r2x_clean"])
    edges = graph_json(None, cfg)["edges"]
    callees = {e["callee"] for e in edges if e["caller"] == "hot_driver:sweep"}
    assert callees == {"helpers:on_device", "helpers:verdict"}


def test_r7_messages_name_the_entry_and_the_wrapper():
    msgs = {(r.path, f.line): f.message
            for r in lint_pack("r7_violation", **PACKS["r7_violation"][0])
            for f in r.findings}
    assert "CUDA entry 'sbgt_scale'" in msgs[("search/driver.py", 11)]
    assert "ops/ wrapper" in msgs[("search/driver.py", 11)]
    assert "'sbgt_orphan'" in msgs[("_kernels.py", 4)]
    assert "[tool.torchlint] thread_roots" in msgs[("torchlint.toml", 1)]


def test_r7_wrapper_modules_may_reach_the_entry():
    """The same reference from ops/ is the wrapper's own launch; with no
    wrapper glob every dispatch module is held to the rule."""
    cfg = dict(PACKS["r7_violation"][0], kernel_wrappers=[])
    got = pack_found(lint_pack("r7_violation", **cfg))
    assert ("R7", "ops/scale.py", 8) in got


def test_r8_message_names_the_merge_key():
    msgs = [f.message for r in lint_pack("r8_violation", **PACKS["r8_violation"][0])
            for f in r.findings]
    assert all("merge key" in m for m in msgs)


def test_r9_typed_local_is_no_false_cycle():
    """Two classes with an ``observe`` method and two unrelated locks:
    the registry's ``h.observe`` is its Histogram's (``h`` is built by
    ``Histogram()`` in the same body), so its lock never reaches the
    timer's gate lock.  The JAX analyzer resolves ``h.observe`` by name to
    every ``observe`` and reports a cycle; the port's tree had exactly
    this shape (telemetry/metrics.py against telemetry/attribution.py)."""
    root = os.path.join(FIXTURES, "r9_typed_clean")
    jcfg = JaxlintConfig(root=root, paths=["."], whole_program=True,
                         **CLEAN_PACKS["r9_typed_clean"])
    jax_found = pack_found(jax_lint_project(config=jcfg))
    assert jax_found == [("R9", "registry.py", 24)]
    assert pack_found(lint_pack("r9_typed_clean",
                                **CLEAN_PACKS["r9_typed_clean"])) == []


def test_cov_counts_an_arm_call_on_any_receiver():
    """The port's tests arm either package's registry through a call
    (``_faults(pkg).arm(site, ...)``): that is an ``arm()`` call too.
    The JAX scanner reads the receiver by name and misses it."""
    tree = os.path.join(JAX_FIXTURES, "r7_violation")
    tests = {"tests/test_x.py": 'def t(pkg):\n    _faults(pkg).arm("ckpt.write", "raise")\n'}
    jcfg, tcfg = _configs(dict(rules=["R7"]), tree, tree)
    _, tgraph = lint_project(config=tcfg, return_graph=True)
    _, jgraph = jax_lint_project(config=jcfg, return_graph=True)
    assert chaos_coverage(tgraph, tcfg, tests)["uncovered"] == []
    assert jax_coverage(jgraph, jcfg, tests)["uncovered"] == ["ckpt.write"]


def test_pack_scan_is_deterministic():
    a = [f.message for r in lint_pack("r7_violation", **PACKS["r7_violation"][0])
         for f in r.findings]
    b = [f.message for r in lint_pack("r7_violation", **PACKS["r7_violation"][0])
         for f in r.findings]
    assert a == b
