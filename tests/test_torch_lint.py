"""Tier-1 gate: the port's tree holds at zero unsuppressed torchlint
findings, and the port's pre-existing modules keep their statements.

The tree is scanned once for the whole file (``scan``, in process, the
whole-program pass with every rule of ``torchlint.toml``); the CLI's
formats, exit codes and baseline handling run through ``cli.main`` on that
scan's reports, and through ``python -m sboxgates_tpu_torch.analysis`` on
small projects of their own.
"""

import ast
import json
import os
import subprocess
import sys
import time

import pytest

from sboxgates_tpu_torch.analysis import cli, load_config
from sboxgates_tpu_torch.analysis.callgraph import spec_matches_function
from sboxgates_tpu_torch.analysis.durability import (
    _scan_test_source,
    chaos_coverage,
)
from sboxgates_tpu_torch.analysis.project import graph_payload, lint_project

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_ast_digests as ast_digests  # noqa: E402

ROOT = ast_digests.ROOT


@pytest.fixture(scope="module")
def scan():
    """One whole-program scan of the port's tree: config, reports, graph,
    wall seconds and ``ast.parse`` calls."""
    config = load_config(ROOT)
    calls = {"n": 0}
    real_parse = ast.parse

    def counting_parse(*args, **kwargs):
        calls["n"] += 1
        return real_parse(*args, **kwargs)

    ast.parse = counting_parse
    try:
        t0 = time.monotonic()
        reports, graph = lint_project(config=config, return_graph=True)
        seconds = time.monotonic() - t0
    finally:
        ast.parse = real_parse
    return dict(config=config, reports=reports, graph=graph,
                seconds=seconds, parses=calls["n"])


def test_port_scan_has_zero_unsuppressed_findings(scan):
    findings = [f for r in scan["reports"] for f in r.findings]
    assert findings == [], "\n".join(f.render() for f in findings)
    # the scan covered the port, and it carries reasoned suppressions
    paths = {r.path for r in scan["reports"]}
    assert len(paths) > 60
    assert all(p.startswith("sboxgates_tpu_torch/") for p in paths)
    assert sum(len(r.suppressed) for r in scan["reports"]) > 0


def test_whole_program_pass_parses_once_and_runs_every_rule(scan):
    assert scan["parses"] == len(scan["reports"])
    assert scan["seconds"] < 60.0, f"scan took {scan['seconds']:.1f}s"
    every = set(scan["config"].rules)
    # R2 runs in hot modules only, R6 outside telemetry/ only
    assert all(every - {"R2", "R6"} <= r.checked for r in scan["reports"])
    sup_rules = {f.rule for r in scan["reports"] for f in r.suppressed}
    # the acknowledged sources and inline markers of the cross-module
    # passes exist only when those passes ran
    assert {"R2", "R2x", "R5", "R7", "R11", "R12", "R13", "R14"} <= sup_rules


def test_config_comes_from_torchlint_toml(scan):
    config = scan["config"]
    assert config.root == ROOT
    assert config.paths == ["sboxgates_tpu_torch"]
    assert config.rules == [
        "R1", "R2", "R3", "R4", "R5", "R6",
        "R1x", "R2x", "R4x", "R7", "R8", "R9",
        "R10", "R11", "R12", "R13", "R14", "R15",
    ]
    assert config.whole_program
    assert config.is_excluded("tests/torch_analysis_fixtures/r7_clean/x.py")
    assert config.is_hot("sboxgates_tpu_torch/search/lut.py")
    assert config.is_hot("sboxgates_tpu_torch/ops/sweeps.py")
    assert not config.is_hot("sboxgates_tpu_torch/search/context.py")
    assert config.is_dispatch("sboxgates_tpu_torch/search/lut.py")
    assert not config.is_dispatch("sboxgates_tpu_torch/telemetry/metrics.py")
    assert config.is_kernel_wrapper("sboxgates_tpu_torch/ops/pivot_tile.py")
    assert not config.is_kernel_wrapper("sboxgates_tpu_torch/search/lut.py")
    assert config.is_durable("sboxgates_tpu_torch/store/store.py")
    assert config.is_durable("sboxgates_tpu_torch/serve_net/admission.py")
    assert not config.is_durable("sboxgates_tpu_torch/search/lut.py")
    assert config.is_handler("sboxgates_tpu_torch/serve_net/server.py")
    assert "breach_verdict" in config.agreement_sites
    assert "all_reduce" in config.agreement_sites
    assert "store.wait" in config.agreement_sites
    assert "is_primary" in config.rank_sources
    assert any(w.startswith("native.devcb:") for w in config.chaos_waivers)
    assert config.test_globs == ["tests/test_torch_*.py", "tests/torch_*.py"]


NAME_KEYS = ("bucket_sources", "blocking_calls", "rank_sources",
             "agreement_sites", "auth_sites", "quota_sites", "journal_sites",
             "effect_sites", "response_sites", "durable_helpers",
             "sanitizers", "untrusted_sources", "deterministic_sinks")


@pytest.mark.parametrize("key", NAME_KEYS)
def test_every_configured_name_is_the_ports(scan, key):
    """A name the port does not have either fires as a stale pin or
    silently hides a rule: each must occur in the port's source (a dotted
    entry by its last part), or be a library call the rule watches."""
    library = {"len", "int", "float", "open", "sha256", "blake2b",
               "hexdigest", "urlsplit", "parse_qs", "recv", "default_rng",
               "SeedSequence", "all_reduce", "all_gather", "broadcast",
               "subprocess.run", "subprocess.Popen", "subprocess.call",
               "os.system", "os.remove", "os.rename", "path.join"}
    text = []
    for r in scan["reports"]:
        if r.path.startswith("sboxgates_tpu_torch/analysis/"):
            continue
        with open(os.path.join(ROOT, r.path), encoding="utf-8") as f:
            text.append(f.read())
    text = "\n".join(text)
    for name in getattr(scan["config"], key):
        if name in library:
            continue
        assert name.rsplit(".", 1)[-1] in text, f"{key}: {name!r}"


def test_every_thread_creation_is_pinned(scan):
    config, graph = scan["config"], scan["graph"]
    assert graph.thread_creations, "no Thread creations found"
    for tc in graph.thread_creations:
        assert tc.targets, f"unresolved Thread target at {tc.path}:{tc.line}"
        assert any(
            spec_matches_function(spec, t)
            for spec in config.thread_roots for t in tc.targets
        ), f"unpinned Thread target {tc.targets} at {tc.path}:{tc.line}"
    for spec in config.thread_roots:
        assert any(
            spec_matches_function(spec, key) for key in graph.functions
        ), f"stale thread_roots pin {spec!r}"
    # the JAX package's warmer has no counterpart in the port
    assert "KernelWarmer._work" not in config.thread_roots


def test_graph_and_lock_order_cover_every_thread_root(scan):
    graph = graph_payload(scan["graph"])
    pre = "sboxgates_tpu_torch.ops.combinatorics:ChunkPrefetcher."
    assert pre + "_work" in graph["thread_roots"]
    assert ("sboxgates_tpu_torch.resilience.deadline:"
            "run_with_deadline.<locals>.work") in graph["thread_roots"]
    pairs = {(e["caller"], e["callee"]) for e in graph["edges"]}
    assert (pre + "_work", pre + "_produce_one") in pairs
    lo = graph["lock_order"]
    assert lo["cycles"] == []
    assert set(lo["root_acquires"]) == set(graph["thread_roots"])
    acq = lo["root_acquires"]
    assert ("sboxgates_tpu_torch.ops.combinatorics._native_probe_lock"
            in acq[pre + "_work"])
    assert lo["edges"]
    # no compiled functions in the port today: R1/R1x/R3 hold fixtures
    assert graph["jit_roots"] == []


def test_chaos_coverage_gate(scan):
    report = chaos_coverage(scan["graph"], scan["config"])
    assert report["uncovered"] == []
    assert report["stale_waivers"] == []
    assert report["declared_total"] >= 22
    assert report["sites"]["native.devcb"]["waiver"]
    assert report["sites"]["native.devcb"]["armed_by"] == []
    assert report["sites"]["dist.verdict"]["armed_by"] == [
        "tests/test_torch_verdict.py"]
    # only the port's tests count
    for site in report["sites"].values():
        for rel in site["armed_by"]:
            base = os.path.basename(rel)
            assert base.startswith(("test_torch_", "torch_")), rel


def test_bare_site_names_arm_only_with_fault_plumbing():
    declared = {"ckpt.replace"}
    quoted = 'def test_gate():\n    assert sites["ckpt.replace"]\n'
    assert _scan_test_source(quoted, declared) == set()
    # an arm() through a call (``_faults(pkg)``, either package's registry)
    # is fault plumbing, so the parametrized bare names count too
    chained = ('def t(pkg):\n    _faults(pkg).arm("ckpt.write", "raise")\n'
               '    go("ckpt.replace")\n')
    assert _scan_test_source(chained, declared | {"ckpt.write"}) == {
        "ckpt.write", "ckpt.replace"}


def test_committed_baseline_is_zero_findings():
    with open(os.path.join(ROOT, "torchlint_baseline.json"),
              encoding="utf-8") as f:
        baseline = json.load(f)
    assert baseline["findings"] == []
    assert baseline["suppressed"]


def _main(monkeypatch, scan, argv, capsys):
    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(cli, "lint_paths", lambda *a, **k: scan["reports"])
    rc = cli.main(argv)
    return rc, capsys.readouterr()


def test_cli_json_sarif_and_baseline_on_the_scan(scan, monkeypatch, capsys,
                                                 tmp_path):
    sarif = tmp_path / "scan.sarif"
    rc, out = _main(monkeypatch, scan,
                    ["--format", "json", "--sarif", str(sarif),
                     "--baseline", "torchlint_baseline.json"], capsys)
    assert rc == 0, out.err
    payload = json.loads(out.out)
    assert payload["findings"] == []
    assert payload["files_scanned"] == len(scan["reports"])
    doc = json.loads(sarif.read_text(encoding="utf-8"))
    assert doc["version"] == "2.1.0"
    driver = doc["runs"][0]["tool"]["driver"]
    assert driver["name"] == "torchlint"
    assert {"R1", "R2", "R3", "R7", "R15", "COV", "SUP"} <= {
        r["id"] for r in driver["rules"]}
    assert doc["runs"][0]["results"] == []


def test_cli_human_format_on_the_scan(scan, monkeypatch, capsys):
    rc, out = _main(monkeypatch, scan, [], capsys)
    assert rc == 0
    assert out.out.startswith("torchlint: 0 finding(s), ")
    assert "suppressed" in out.out


def test_list_rules_documents_the_torch_rules():
    proc = subprocess.run(
        [sys.executable, "-m", "sboxgates_tpu_torch.analysis",
         "--list-rules"],
        cwd=ROOT, capture_output=True, text=True, timeout=60,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = {ln.split()[0]: ln for ln in proc.stdout.splitlines()}
    assert "torch.compile" in lines["R1"]
    assert "CUDA graph capture" in lines["R3"]
    for rid in ("R13", "R14", "R15", "COV", "SUP", "ERR"):
        assert rid in lines


def _project(tmp_path, body, rules="R5", whole="false"):
    repo = tmp_path / "proj"
    (repo / "pkg").mkdir(parents=True)
    (repo / "torchlint.toml").write_text(
        "[tool.torchlint]\n"
        'paths = ["pkg"]\n'
        f'rules = ["{rules}"]\n'
        f"whole_program = {whole}\n"
    )
    (repo / "pkg" / "a.py").write_text(body)
    return repo


def _run(repo, *argv):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "sboxgates_tpu_torch.analysis", *argv],
        cwd=repo, env=env, capture_output=True, text=True, timeout=120,
    )


SWALLOW = (
    "def f():\n"
    "    try:\n"
    "        probe()\n"
    "    except Exception:\n"
    "        pass\n"
)


def test_cli_exit_codes_and_sarif_locations(tmp_path):
    repo = _project(tmp_path, SWALLOW + SWALLOW.replace("def f", "def g"))
    (repo / "base.json").write_text(json.dumps({
        "schema": 1, "findings": [{"path": "pkg/a.py", "line": 4,
                                   "rule": "R5"}]}))
    out = repo / "scan.sarif"
    proc = _run(repo, "--baseline", "base.json", "--sarif", str(out))
    assert proc.returncode == 1, proc.stdout + proc.stderr  # one new
    results = json.loads(out.read_text())["runs"][0]["results"]
    by_line = {r["locations"][0]["physicalLocation"]["region"]["startLine"]:
               r for r in results}
    assert sorted(by_line) == [4, 9]
    assert by_line[4]["suppressions"] == [{"kind": "external"}]
    assert "suppressions" not in by_line[9]
    loc = by_line[9]["locations"][0]["physicalLocation"]
    assert loc["artifactLocation"]["uri"] == "pkg/a.py"
    assert loc["region"]["startColumn"] >= 1
    # write the baseline, then it matches exactly
    assert _run(repo, "--write-baseline", "b2.json").returncode == 0
    assert _run(repo, "--baseline", "b2.json").returncode == 0
    # a bad rule id is a usage error
    bad = _run(repo, "--rules", "R99")
    assert bad.returncode == 2 and "R99" in bad.stderr


def test_cli_suppression_marker_and_whole_program_switches(tmp_path):
    body = SWALLOW.replace(
        "    except Exception:\n",
        "    # torchlint: ignore[R5] the probe's failure is the answer\n"
        "    except Exception:\n",
    )
    repo = _project(tmp_path, body, rules="R5", whole="true")
    proc = _run(repo, "--format", "json")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout)
    assert payload["findings"] == []
    assert [s["rule"] for s in payload["suppressed"]] == ["R5"]
    assert _run(repo, "--no-whole-program").returncode == 0
    graph = json.loads(_run(repo, "--graph").stdout)
    assert "pkg.a:f" in graph["functions"]
    cov = _run(repo, "--coverage", "--format", "json")
    assert cov.returncode == 0 and json.loads(cov.stdout)["declared_total"] == 0


def _git(repo, *argv):
    subprocess.run(["git", "-c", "user.email=t@t", "-c", "user.name=t",
                    *argv], cwd=repo, check=True, capture_output=True)


def test_cli_diff_base_reports_only_new_findings(tmp_path):
    repo = _project(tmp_path, SWALLOW)
    _git(repo, "init", "-q")
    _git(repo, "add", "-A")
    _git(repo, "commit", "-q", "-m", "base")
    same = _run(repo, "--diff-base", "HEAD", "--format", "json")
    assert same.returncode == 0
    assert json.loads(same.stdout)["new_findings"] == []
    (repo / "pkg" / "a.py").write_text(
        "def pad():\n    return 0\n\n\n" + SWALLOW
        + "\n\n" + SWALLOW.replace("def f", "def fresh"))
    proc = _run(repo, "--diff-base", "HEAD", "--format", "json")
    assert proc.returncode == 1, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout)
    assert payload["total_findings"] == 2
    assert [f["line"] for f in payload["new_findings"]] == [15]
    bad = _run(repo, "--diff-base", "no-such-ref")
    assert bad.returncode == 2 and "no-such-ref" in bad.stderr


# -- the port's runtime statements are the recorded ones ------------------


def _digests():
    with open(ast_digests.DIGESTS, encoding="utf-8") as f:
        return json.load(f)["ast_dump_sha256"]


def test_digests_cover_every_pre_existing_module():
    """Every runtime module of the port has a recorded digest, and every
    recorded module exists."""
    assert sorted(_digests()) == ast_digests.runtime_modules()


@pytest.mark.parametrize("rel", sorted(_digests()))
def test_pre_existing_module_keeps_its_statements(rel):
    """Comments (suppression markers) change no statement: every runtime
    module of the port keeps its recorded AST dump.  A change that alters
    statements on purpose records them again with
    ``python tests/torch_ast_digests.py``."""
    with open(os.path.join(ROOT, rel), encoding="utf-8") as f:
        assert ast_digests.digest(f.read()) == _digests()[rel]
