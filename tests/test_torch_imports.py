"""The PyTorch port stands alone: importing any of its modules pulls in
neither JAX nor the JAX package, and no source file imports them."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "sboxgates_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "sboxgates_tpu")


def _sources():
    out = []
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(dirpath, f), ROOT))
    return sorted(out)


def _module_name(rel):
    mod = rel[:-3].replace(os.sep, ".")
    return mod[: -len(".__init__")] if mod.endswith(".__init__") else mod


SOURCES = _sources()


def test_package_has_the_slice_modules():
    mods = {_module_name(s) for s in SOURCES}
    for name in (
        "sboxgates_tpu_torch.cli",
        "sboxgates_tpu_torch._kernels",
        "sboxgates_tpu_torch.ops.sweeps",
        "sboxgates_tpu_torch.ops.lut5_filter",
        "sboxgates_tpu_torch.ops.pivot_tile",
        "sboxgates_tpu_torch.ops.spectral",
        "sboxgates_tpu_torch.codegen.executor",
        "sboxgates_tpu_torch.codegen.cuda_kernel",
        "sboxgates_tpu_torch.codegen.c_emit",
        "sboxgates_tpu_torch.codegen.dot",
        "sboxgates_tpu_torch.search.kwan",
        "sboxgates_tpu_torch.graph.xmlio",
        "sboxgates_tpu_torch.native",
        "sboxgates_tpu_torch.resilience.faults",
        "sboxgates_tpu_torch.resilience.journal",
        "sboxgates_tpu_torch.resilience.deadline",
        "sboxgates_tpu_torch.resilience.checkpoint",
        "sboxgates_tpu_torch.telemetry",
        "sboxgates_tpu_torch.telemetry.metrics",
        "sboxgates_tpu_torch.telemetry.trace",
        "sboxgates_tpu_torch.telemetry.flight",
        "sboxgates_tpu_torch.telemetry.heartbeat",
        "sboxgates_tpu_torch.telemetry.attribution",
        "sboxgates_tpu_torch.telemetry.status",
        "sboxgates_tpu_torch.telemetry.watch",
        "sboxgates_tpu_torch.parallel",
        "sboxgates_tpu_torch.parallel.mesh",
        "sboxgates_tpu_torch.parallel.distributed",
        "sboxgates_tpu_torch.utils.profile",
        "sboxgates_tpu_torch.utils.guards",
        "sboxgates_tpu_torch.search.batched",
        "sboxgates_tpu_torch.search.fleet",
        "sboxgates_tpu_torch.search.multibox",
        "sboxgates_tpu_torch.search.warmup",
        "sboxgates_tpu_torch.search.rounds",
        "sboxgates_tpu_torch.search.serve",
        "sboxgates_tpu_torch.core.canon",
        "sboxgates_tpu_torch.store",
        "sboxgates_tpu_torch.store.store",
        "sboxgates_tpu_torch.store.rewrite",
        "sboxgates_tpu_torch.serve_net",
        "sboxgates_tpu_torch.serve_net.tokens",
        "sboxgates_tpu_torch.serve_net.admission",
        "sboxgates_tpu_torch.serve_net.server",
        "sboxgates_tpu_torch.analysis",
        "sboxgates_tpu_torch.analysis.__main__",
        "sboxgates_tpu_torch.analysis.config",
        "sboxgates_tpu_torch.analysis.rules",
        "sboxgates_tpu_torch.analysis.cli",
        "sboxgates_tpu_torch.analysis.project",
        "sboxgates_tpu_torch.analysis.callgraph",
        "sboxgates_tpu_torch.analysis.registries",
        "sboxgates_tpu_torch.analysis.bucketflow",
        "sboxgates_tpu_torch.analysis.lockorder",
        "sboxgates_tpu_torch.analysis.protocol",
        "sboxgates_tpu_torch.analysis.determinism",
        "sboxgates_tpu_torch.analysis.durability",
        "sboxgates_tpu_torch.analysis.trustflow",
        "sboxgates_tpu_torch.analysis.ordering",
        "sboxgates_tpu_torch.analysis.lifecycle",
    ):
        assert name in mods


def test_analysis_is_pure_stdlib():
    """The static analyzer runs on any host: importing it (and running its
    CLI's rule table) loads neither torch nor numpy."""
    code = (
        "import sys\n"
        "from sboxgates_tpu_torch.analysis.cli import main\n"
        "assert main(['--list-rules']) == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'numpy', 'jax', 'jaxlib', 'sboxgates_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=60,
    )
    assert out.returncode == 0, out.stdout + out.stderr


def test_importing_every_module_loads_neither_jax_nor_reference():
    mods = [_module_name(s) for s in SOURCES if not s.endswith("__main__.py")]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr


def test_native_runtime_and_a_gate_search_load_neither_jax_nor_reference(tmp_path):
    """The port's ctypes loader builds and loads the runtime, and a gate-mode
    search through the native engine runs, without loading a module of
    JAX or of the JAX package (its native binding included)."""
    code = (
        "import sys\n"
        "from sboxgates_tpu_torch import native\n"
        "assert native.available(), native.build_error()\n"
        "from sboxgates_tpu_torch.cli import main\n"
        f"rc = main(['-o', '0', '--seed', '1', '--device', 'cpu', "
        f"'--output-dir', {str(tmp_path)!r}, "
        f"{os.path.join(ROOT, 'tests', 'data', 'crypto1_fa.txt')!r}])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(rc, bad)\n"
        "sys.exit(1 if bad or rc else 0)\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    env.pop("SBG_DISABLE_NATIVE", None)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert sorted(os.listdir(tmp_path)) == [
        "1-006-0057-0-13a4fed5.xml", "metrics.json", "search.journal.json",
        "search.journal.jsonl", "telemetry.jsonl"]


@pytest.mark.parametrize("rel", SOURCES)
def test_source_imports_no_jax(rel):
    with open(os.path.join(ROOT, rel), encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=rel)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (rel, name)
