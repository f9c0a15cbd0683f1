"""The port's CLI in gate mode and on its default (native) route, against
files the JAX CLI wrote.

Every golden file under tests/data/torch_golden/gate/<case>_<route>/ was
written by the JAX CLI in a fresh process on the CPU, one process per
case and route:

    JAX_PLATFORMS=cpu SBG_WARMUP=0 [SBG_DISABLE_NATIVE=1] \\
        python -m sboxgates_tpu <argv of CASES[case]> --output-dir D

with ``SBG_DISABLE_NATIVE=1`` for the ``off`` route (every node on the
device sweeps) and without it for the ``native`` route (the JAX CLI's
default: the native host runtime and its engines).  The port writes the
same files, byte for byte, with the variable set or unset the same way,
and the JAX CLI's journal beside them (held against the JAX CLI's live
runs, whose files hold the absolute input paths).
The LUT-mode cases hold the default route; their native-off files are
tests/data/torch_golden/des_s1_l_o0_seed1.xml and
rijndael_planted_l_o0_seed1_g99.xml (tests/test_torch_search.py), and the
G = 99 resume writes that same file on both routes, its pivot sweep run
through the LUT engine's device-work service.  DES S1 gate mode with
native off (the JAX CLI's 1-021-0197-0-7d4eef05.xml, about 100 s here) is
held on the card by chip_smoke.py phase 7a.  The crypto1 goldens are
also held against the JAX CLI live: one fresh process per route runs
every case of CASES (``jax_gate_runs``).
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from sboxgates_tpu_torch import cli

# The suite runs several worker processes on shared cores; torch's
# intra-op thread pool in each of them oversubscribes the host.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
GOLDEN = os.path.join(DATA, "torch_golden")
GATE = os.path.join(GOLDEN, "gate")
FA = os.path.join(DATA, "crypto1_fa.txt")
FB = os.path.join(DATA, "crypto1_fb.txt")
FC = os.path.join(DATA, "crypto1_fc.txt")
DES = os.path.join(DATA, "des_s1.txt")
FA_NATIVE = os.path.join(GATE, "fa_native", "1-006-0057-0-13a4fed5.xml")

CASES = {
    "fa": ["-o", "0", "--seed", "1", FA],
    "fb": ["-o", "0", "--seed", "1", FB],
    "fc": ["-o", "0", "--seed", "1", FC],
    "fa_nots": ["-o", "0", "-n", "--seed", "2", FA],
    "fb_sat": ["-o", "0", "-s", "--seed", "3", FB],
    "fc_gates": ["-o", "0", "-a", "150", "--seed", "4", FC],
    "fa_iter2": ["-o", "0", "-i", "2", "--seed", "5", FA],
    "fc_all": ["-i", "2", "--seed", "3", FC],
    "fb_resume": ["-o", "0", "--seed", "2", "-g", FA_NATIVE, FB],
}
NATIVE_ONLY = {
    "des": ["-o", "0", "--seed", "1", DES],
    "des_l": ["-l", "-o", "0", "--seed", "1", DES],
}
G99_ARGV = ["-l", "-o", "0", "--seed", "1", "-g",
            os.path.join(GOLDEN, "rijndael_g99_state.xml"),
            os.path.join(GOLDEN, "rijndael_planted_bit0.txt")]
G99_GOLDEN = os.path.join(GOLDEN, "rijndael_planted_l_o0_seed1_g99.xml")


def _xml_files(d):
    return {
        n: open(os.path.join(d, n), "rb").read()
        for n in sorted(os.listdir(d)) if n.endswith(".xml")
    }


JOURNAL = ("search.journal.jsonl", "search.journal.json")


def _journal_files(d):
    return {n: open(os.path.join(d, n), "rb").read() for n in JOURNAL}


# (case, route) -> the XML files and journal of the port's run, kept for
# the comparison with the JAX CLI's live runs at the end of the file.
_PORT_RUNS = {}


def _route(monkeypatch, route):
    if route == "native":
        monkeypatch.delenv("SBG_DISABLE_NATIVE", raising=False)
    else:
        monkeypatch.setenv("SBG_DISABLE_NATIVE", "1")


def _run(argv, tmp_path, capsys, key=None):
    """The port's CLI on the CPU into ``tmp_path``, which then holds only the
    XML files and the journal; kept under ``key`` in _PORT_RUNS."""
    rc = cli.main(argv + ["--device", "cpu", "--output-dir", str(tmp_path)])
    out = capsys.readouterr()
    assert rc == 0, out.err
    rest = sorted(n for n in os.listdir(tmp_path) if not n.endswith(".xml"))
    assert rest == sorted(JOURNAL + ("metrics.json", "telemetry.jsonl")), rest
    got = _xml_files(str(tmp_path))
    if key is not None:
        _PORT_RUNS[key] = (got, _journal_files(str(tmp_path)))
    return got, out


def _port_run(key, argv, tmp_path, capsys, monkeypatch):
    """The port's run of ``key`` = (case, route): from _PORT_RUNS, or run
    now (when this test runs alone)."""
    if key not in _PORT_RUNS:
        _route(monkeypatch, key[1])
        _run(argv, tmp_path, capsys, key)
    return _PORT_RUNS[key]


@pytest.mark.parametrize("route", ["native", "off"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_gate_mode_writes_the_jax_clis_files(name, route, tmp_path, capsys,
                                             monkeypatch):
    _route(monkeypatch, route)
    got, _ = _run(CASES[name], tmp_path, capsys, (name, route))
    want = _xml_files(os.path.join(GATE, f"{name}_{route}"))
    assert want and sorted(got) == sorted(want)
    for n in want:
        assert got[n] == want[n], n


@pytest.mark.parametrize("name", sorted(NATIVE_ONLY))
def test_default_route_writes_the_jax_clis_default_file(name, tmp_path, capsys,
                                                        monkeypatch):
    _route(monkeypatch, "native")
    got, _ = _run(NATIVE_ONLY[name], tmp_path, capsys, (name, "native"))
    want = _xml_files(os.path.join(GATE, f"{name}_native"))
    assert got == want


def test_g99_resume_goes_through_the_engine_service(tmp_path, capsys,
                                                    monkeypatch):
    """The default route's G = 99 resume: the LUT engine hands the node's
    pivot-sized 5-LUT search (kind 1) to the device service once and
    writes the JAX CLI's file."""
    from sboxgates_tpu_torch.search import kwan

    kinds = []
    make = kwan._lut_engine_service

    def counting(ctx):
        service = make(ctx)

        def wrapped(kind, *args):
            kinds.append(kind)
            return service(kind, *args)

        return wrapped

    monkeypatch.setattr(kwan, "_lut_engine_service", counting)
    _route(monkeypatch, "native")
    got, _ = _run(G99_ARGV, tmp_path, capsys)
    assert kinds == [1]
    assert list(got.values()) == [open(G99_GOLDEN, "rb").read()]


@pytest.mark.parametrize("argv,message", [
    (["-o", "0", "-i", "0", FA], "Bad iterations value: 0"),
    (["-o", "9", FA], "Bad output value: 9"),
    (["-o", "0", "-a", "0", FA], "Bad available gates value: 0"),
    (["-o", "0", "-p", "256", FA], "Bad permutation value: 256"),
    (["-l", "-s", "-o", "0", FA],
     "SAT metric can not be combined with LUT graph generation."),
    (["-o", "1", FA], "Error: Can't generate output bit 1. Target S-box only "
                      "has 1 outputs."),
])
def test_gate_mode_failures_match_the_jax_cli(argv, message, capsys, tmp_path):
    from sboxgates_tpu import cli as jcli

    assert jcli.main(argv + ["--output-dir", str(tmp_path / "j")]) == 1
    want = capsys.readouterr().err.strip().splitlines()[-1]
    assert cli.main(argv + ["--device", "cpu", "--output-dir", str(tmp_path)]) == 1
    got = capsys.readouterr().err.strip()
    assert got == want == message


def test_threaded_engine_mux_is_rejected(monkeypatch, capsys, tmp_path):
    """The threaded engine mux (the LUT engine's, ported since) is no
    longer rejected: a gate-mode run, whose gate engine has no threaded mux,
    writes the JAX CLI's file on the native route with the variable set, and
    the device route runs no engine and ignores it, as the JAX CLI does
    (the LUT engine's threaded mux: tests/test_torch_batched.py)."""
    monkeypatch.setenv("SBG_ENGINE_MUX_THREADS", "4")
    _route(monkeypatch, "native")
    got, _ = _run(CASES["fa"], tmp_path / "native", capsys)
    assert got == _xml_files(os.path.join(GATE, "fa_native"))
    _route(monkeypatch, "off")
    got, _ = _run(CASES["fa"], tmp_path / "off", capsys)
    assert got == _xml_files(os.path.join(GATE, "fa_off"))


# Runs the JAX CLI on every case of argv[1] (JSON) into argv[2]/<case>;
# the route is chosen by SBG_DISABLE_NATIVE in the environment, before the
# JAX package first loads its native runtime.  A native run without that
# runtime would write the other route's files, so it fails outright.  (Last
# in this file: the JAX package's tests in the other workers build its
# library at the start of a run.)
_JAX_RUNNER = r"""
import json, os, sys
from sboxgates_tpu import native
from sboxgates_tpu.cli import main
if not os.environ.get("SBG_DISABLE_NATIVE") and not native.available():
    sys.exit(f"native runtime unavailable: {native.build_error()}")
cases = json.loads(sys.argv[1])
rcs = {}
for name, argv in cases.items():
    d = os.path.join(sys.argv[2], name)
    os.makedirs(d)
    rcs[name] = main(argv + ["--output-dir", d])
print(json.dumps(rcs))
"""


@pytest.fixture(scope="module")
def jax_gate_runs(tmp_path_factory):
    """{route: directory} of the JAX CLI's files for every case of CASES,
    each route run in one fresh process."""
    # One core and no Eigen thread pool: the suite's other workers share
    # the host, and these searches are dispatch-bound anyway.
    core = max(os.sched_getaffinity(0))
    runs = {}
    for route in ("native", "off"):
        out = tmp_path_factory.mktemp(f"jax_gate_{route}")
        env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
                   SBG_WARMUP="0")
        env["XLA_FLAGS"] = (
            env.get("XLA_FLAGS", "") + " --xla_cpu_multi_thread_eigen=false"
        ).strip()
        if route == "native":
            env.pop("SBG_DISABLE_NATIVE", None)
        else:
            env["SBG_DISABLE_NATIVE"] = "1"
        cases = dict(CASES, **NATIVE_ONLY) if route == "native" else CASES
        proc = subprocess.run(
            [sys.executable, "-c", _JAX_RUNNER, json.dumps(cases), str(out)],
            cwd=str(out), env=env, capture_output=True, text=True, timeout=600,
            preexec_fn=lambda: os.sched_setaffinity(0, {core}),
        )
        assert proc.returncode == 0, proc.stderr[-3000:]
        rcs = json.loads(proc.stdout.strip().splitlines()[-1])
        assert rcs == {name: 0 for name in cases}, rcs
        runs[route] = out
    return runs


@pytest.mark.parametrize("route", ["native", "off"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_gate_goldens_are_the_jax_clis_files(name, route, jax_gate_runs):
    want = _xml_files(os.path.join(jax_gate_runs[route], name))
    assert want, "the JAX CLI wrote no state"
    assert _xml_files(os.path.join(GATE, f"{name}_{route}")) == want


@pytest.mark.parametrize("name,route", [(n, r) for n in sorted(CASES)
                                        for r in ("native", "off")]
                         + [(n, "native") for n in sorted(NATIVE_ONLY)])
def test_port_runs_write_the_jax_clis_journal(name, route, jax_gate_runs,
                                              tmp_path, capsys, monkeypatch):
    """The port's run of each case writes the JAX CLI's journal
    (search.journal.jsonl and .json) beside its XML files, byte for byte."""
    argv = dict(CASES, **NATIVE_ONLY)[name]
    xml, journal = _port_run((name, route), argv, tmp_path, capsys, monkeypatch)
    d = os.path.join(jax_gate_runs[route], name)
    assert xml == _xml_files(d)
    assert journal == _journal_files(d)
