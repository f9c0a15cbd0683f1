"""The port's CLI end to end on the CPU against the JAX package's CLI.

With the native runtime off in both packages (``SBG_DISABLE_NATIVE=1``:
every node on the device sweeps), the same command writes the same XML
state files and the same journal (``search.journal.jsonl`` and
``search.journal.json``), byte for byte, and nothing else.  The JAX runs share one subprocess
(the native switch must be set before that package first loads its
runtime).  DES S1 is also held against the committed file the JAX CLI
wrote for the same command (tests/data/torch_golden/), the file the chip
smoke test checks.  Bad flags fail with the JAX CLI's one-line messages.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sboxgates_tpu_torch import cli
from sboxgates_tpu_torch.core import ttable as tt
from sboxgates_tpu_torch.graph.xmlio import load_state
from sboxgates_tpu_torch.search import Options, SearchContext
from sboxgates_tpu_torch.utils.sbox import load_sbox

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_states import planted_sbox, random_state  # noqa: E402

# The suite runs several worker processes on shared cores; torch's
# intra-op thread pool in each of them oversubscribes the host.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
GOLDEN = os.path.join(DATA, "torch_golden")
FA = os.path.join(DATA, "crypto1_fa.txt")
FB = os.path.join(DATA, "crypto1_fb.txt")
FC = os.path.join(DATA, "crypto1_fc.txt")
DES = os.path.join(DATA, "des_s1.txt")
FA_GOLDEN = os.path.join(GOLDEN, "crypto1_fa_l_o0_seed1.xml")
# chip_smoke.py phase 4a: the CLI resumes from a G = 99 state against a
# planted 5-LUT, which the pivot sweep finds.
G99_STATE = os.path.join(GOLDEN, "rijndael_g99_state.xml")
G99_SBOX = os.path.join(GOLDEN, "rijndael_planted_bit0.txt")
G99_GOLDEN = os.path.join(GOLDEN, "rijndael_planted_l_o0_seed1_g99.xml")

CASES = {
    "fa_o0": ["-l", "-o", "0", "--seed", "1", FA],
    "fb_o0": ["-l", "-o", "0", "--seed", "1", FB],
    "fc_all_i2": ["-l", "-i", "2", "--seed", "3", FC],
    "fa_gates_permute": ["-l", "-o", "0", "--seed", "5", "-p", "3", "-a", "150", FA],
    "fb_resume_graph": ["-l", "-o", "0", "--seed", "2", "-g", FA_GOLDEN, FB],
    "fc_nots_verbose": ["-l", "-o", "0", "-n", "-v", "--seed", "9", FC],
}
DES_ARGV = ["-l", "-o", "0", "--seed", "1", DES]
G99_ARGV = ["-l", "-o", "0", "--seed", "1", "-g", G99_STATE, G99_SBOX]


def _g50_argv(d):
    """A G = 50 resume that reaches the pivot 5-LUT sweep (C(50,5) is just
    past its threshold) and finds a 5-LUT there after about 10 K
    candidates: random_state(50, 2) against rijndael.txt with output bit 0
    planted on gates 45..49 (tests/torch_states.py).  Writes both inputs to
    ``d``."""
    from sboxgates_tpu_torch.graph.xmlio import state_to_xml
    from sboxgates_tpu_torch.resilience.checkpoint import with_digest

    st = random_state(50, 2)
    state, box = os.path.join(d, "g50_state.xml"), os.path.join(d, "g50_box.txt")
    with open(state, "w") as f:
        f.write(with_digest(state_to_xml(st)))
    sbox = planted_sbox(st, gates=(45, 46, 47, 48, 49))
    with open(box, "w") as f:
        f.write(" ".join("%02x" % v for v in sbox) + "\n")
    return ["-l", "-o", "0", "--seed", "1", "-g", state, box]

_JAX_DRIVER = r"""
import json, os, sys
os.environ["SBG_DISABLE_NATIVE"] = "1"
os.environ["SBG_WARMUP"] = "0"
os.environ["JAX_PLATFORMS"] = "cpu"
from sboxgates_tpu.cli import main
cases = json.loads(sys.argv[1])
out = sys.argv[2]
rcs = {}
for name, argv in cases.items():
    d = os.path.join(out, name)
    os.makedirs(d)
    rcs[name] = main(argv + ["--output-dir", d])
print(json.dumps(rcs))
"""


def _xml_files(d):
    return {
        n: open(os.path.join(d, n), "rb").read()
        for n in sorted(os.listdir(d)) if n.endswith(".xml")
    }


JOURNAL = ("search.journal.jsonl", "search.journal.json")
# What an explicit --output-dir also holds: the heartbeat and the snapshot.
TELEMETRY = ("metrics.json", "telemetry.jsonl")


def _journal_files(d):
    """The run's journal files (the JAX CLI writes them beside its XML)."""
    return {n: open(os.path.join(d, n), "rb").read() for n in JOURNAL}


def _port_journal(d):
    """:func:`_journal_files` of a directory only the port wrote, which must
    hold the XML files, the journal and the telemetry files, as the JAX
    CLI's run directory does, and nothing else."""
    rest = sorted(n for n in os.listdir(d) if not n.endswith(".xml"))
    assert rest == sorted(JOURNAL + TELEMETRY), rest
    return _journal_files(d)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_cli")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    # One core and no Eigen thread pool: the suite's other workers share
    # the host, and these searches are dispatch-bound anyway.
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "") + " --xla_cpu_multi_thread_eigen=false"
    ).strip()
    core = max(os.sched_getaffinity(0))
    inputs = out / "inputs"
    inputs.mkdir()
    cases = dict(CASES, des_o0=DES_ARGV, g99_pivot=G99_ARGV,
                 g50_pivot=_g50_argv(str(inputs)))
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_DRIVER, json.dumps(cases), str(out)],
        cwd=str(out), env=env, capture_output=True, text=True, timeout=600,
        preexec_fn=lambda: os.sched_setaffinity(0, {core}),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    rcs = json.loads(proc.stdout.strip().splitlines()[-1])
    return out, rcs, cases


@pytest.fixture
def native_off(monkeypatch):
    """The port's CLI on its device route, as the JAX runs above."""
    monkeypatch.setenv("SBG_DISABLE_NATIVE", "1")


@pytest.mark.parametrize("name", sorted(CASES))
def test_cli_writes_the_jax_packages_files(name, jax_runs, tmp_path, native_off):
    out, rcs, _ = jax_runs
    assert rcs[name] == 0
    rc = cli.main(CASES[name] + ["--device", "cpu", "--output-dir", str(tmp_path)])
    assert rc == 0
    want = _xml_files(os.path.join(out, name))
    got = _xml_files(str(tmp_path))
    assert want, "the JAX CLI wrote no state"
    assert sorted(got) == sorted(want)
    for n in want:
        assert got[n] == want[n], n
    assert _port_journal(str(tmp_path)) == _journal_files(os.path.join(out, name))


# The JAX CLI's persistent XLA compile cache of an explicit --output-dir:
# the port compiles no XLA and has none.
JAX_ONLY = ("xla_cache",)
# The counters both packages count the same (the reference's own totals);
# dispatch counts differ by design (the port sweeps many tiles per call).
REFERENCE_VISIBLE = ("_candidates", "_solved", "engine_nodes", "python_nodes")
TRACE_FLAGS = ["--trace", "--status-port", "0", "--metrics-interval", "0.05"]


def test_telemetry_flags_keep_the_files_and_write_the_jax_clis_telemetry(
        jax_runs, tmp_path, capsys, native_off):
    """With every telemetry feature on, the XML and the journal are the JAX
    CLI's; the directory holds the JAX CLI's names plus ``trace.json``; the
    heartbeat lines and metrics.json have the JAX CLI's top-level keys and
    reference-visible counters; the trace's dispatch spans are as many as
    ``device_dispatches``."""
    out, rcs, _ = jax_runs
    name = "fa_o0"
    assert rcs[name] == 0
    jdir = os.path.join(out, name)
    rc = cli.main(CASES[name] + ["--device", "cpu", *TRACE_FLAGS, "-v", "-v",
                                 "--output-dir", str(tmp_path)])
    assert rc == 0
    assert "phase " in capsys.readouterr().out  # the -v -v report
    d = str(tmp_path)
    assert _xml_files(d) == _xml_files(jdir)
    assert _journal_files(d) == _journal_files(jdir)
    jnames = [n for n in os.listdir(jdir) if n not in JAX_ONLY]
    assert sorted(os.listdir(d)) == sorted(jnames + ["trace.json"])

    def lines(p):
        return [json.loads(ln) for ln in open(os.path.join(p, "telemetry.jsonl"))]

    got, want = lines(d), lines(jdir)
    for i in (0, -1):
        assert sorted(got[i]) == sorted(want[i]), i
    assert got[0]["kind"] == "start" and got[-1]["kind"] == "final"
    assert got[0]["config"]["status_port"] > 0
    gm = json.load(open(os.path.join(d, "metrics.json")))
    jm = json.load(open(os.path.join(jdir, "metrics.json")))
    assert sorted(gm) == sorted(jm)
    keys = {k for k in set(gm["counters"]) | set(jm["counters"])
            if k.endswith(REFERENCE_VISIBLE)}
    assert keys and {k: gm["counters"].get(k, 0) for k in keys} == {
        k: jm["counters"].get(k, 0) for k in keys}
    trace = json.load(open(os.path.join(d, "trace.json")))["traceEvents"]
    spans = [e for e in trace if e.get("cat") == "dispatch"]
    assert len(spans) == gm["counters"]["device_dispatches"] > 0
    assert gm["attribution"]["backend"] == "cpu"


def test_watch_renders_a_jax_cli_run(jax_runs, capsys):
    """The port's watcher reads the heartbeat the JAX CLI wrote."""
    from sboxgates_tpu_torch.telemetry import watch

    out, _, _ = jax_runs
    assert watch.main([os.path.join(out, "des_o0"), "--once"]) == 0
    text = capsys.readouterr().out
    assert "terminal record" in text and "lut5_candidates" in text


def test_crypto1_golden_is_the_jax_clis_file(jax_runs):
    out, _, _ = jax_runs
    files = _xml_files(os.path.join(out, "fa_o0"))
    with open(FA_GOLDEN, "rb") as f:
        assert list(files.values()) == [f.read()]


def test_des_s1_matches_the_jax_cli_and_golden_file(jax_runs, tmp_path, capsys,
                                                    native_off):
    """``-l -o 0 --seed 1 des_s1.txt``: the file the JAX CLI writes (native
    off), byte for byte, which is also the committed golden file; every
    output gate realizes the S-box bit."""
    out, rcs, _ = jax_runs
    assert rcs["des_o0"] == 0
    rc = cli.main(DES_ARGV + ["--device", "cpu", "--output-dir", str(tmp_path)])
    assert rc == 0
    got = _xml_files(str(tmp_path))
    assert got == _xml_files(os.path.join(out, "des_o0"))
    assert _port_journal(str(tmp_path)) == _journal_files(os.path.join(out, "des_o0"))
    assert list(got) == ["1-011-0000-0-a7556919.xml"]
    with open(os.path.join(GOLDEN, "des_s1_l_o0_seed1.xml"), "rb") as f:
        assert got["1-011-0000-0-a7556919.xml"] == f.read()
    st = load_state(os.path.join(str(tmp_path), "1-011-0000-0-a7556919.xml"))
    sbox, n = load_sbox(DES)
    assert bool(tt.eq_mask(st.table(st.outputs[0]), tt.target_table(sbox, 0),
                           tt.mask_table(n)))
    assert "(1/1): 11 gates. SAT metric: 0" in capsys.readouterr().out


def test_pivot_resume_golden_is_the_jax_clis_file(jax_runs):
    """The file chip_smoke.py holds the card's G = 99 pivot-path resume
    against is what the JAX CLI writes for the same command."""
    out, rcs, _ = jax_runs
    assert rcs["g99_pivot"] == 0
    with open(G99_GOLDEN, "rb") as f:
        assert list(_xml_files(os.path.join(out, "g99_pivot")).values()) == [f.read()]


@pytest.mark.parametrize("backend", ["packed", "pre"])
def test_pivot_backend_flag_writes_the_jax_clis_file(backend, jax_runs, tmp_path,
                                                     monkeypatch, capsys,
                                                     native_off):
    """``--pivot-backend`` picks the pivot tile kernel (on the CPU, its
    plain version) of a search that finds its 5-LUT in the pivot sweep, and
    either one writes the JAX CLI's file."""
    from sboxgates_tpu_torch.ops import pivot_tile

    out, rcs, cases = jax_runs
    assert rcs["g50_pivot"] == 0
    calls = {"packed": 0, "pre": 0}
    for name, attr in (("packed", "pivot_constraints_plain"),
                       ("pre", "pivot_pre_window_plain")):
        real = getattr(pivot_tile, attr)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(pivot_tile, attr, counted)
    rc = cli.main(cases["g50_pivot"] + [
        "--device", "cpu", "--pivot-backend", backend, "-v", "-v",
        "--output-dir", str(tmp_path)])
    assert rc == 0
    stats = dict(kv.split("=") for kv in capsys.readouterr().out.split(
        "stats: ")[1].splitlines()[0].split())
    assert int(stats["lut5_candidates"]) > 0
    assert calls[backend] > 0
    assert calls["pre" if backend == "packed" else "packed"] == 0
    want = _xml_files(os.path.join(out, "g50_pivot"))
    assert want and _xml_files(str(tmp_path)) == want
    # --pivot-backend is not journaled: the JAX CLI's journal, whichever
    # kernel ran.
    assert _port_journal(str(tmp_path)) == _journal_files(
        os.path.join(out, "g50_pivot"))


def test_pivot_resume_inputs_come_from_chip_smokes_generators():
    """The committed G = 99 state and planted S-box are the seeded
    random_state(99, 11) and planted_sbox (tests/torch_states.py, the
    constructions chip_smoke.py keeps a copy of), as the port saves them."""
    from sboxgates_tpu_torch.graph.xmlio import state_to_xml
    from sboxgates_tpu_torch.resilience.checkpoint import with_digest

    st = random_state(99, 11)
    with open(G99_STATE) as f:
        assert f.read() == with_digest(state_to_xml(st))
    sbox = planted_sbox(st)
    with open(G99_SBOX) as f:
        assert f.read() == " ".join("%02x" % v for v in sbox) + "\n"
    target = tt.target_table(sbox, 0)
    outer = tt.eval_lut(0x2D, st.table(90), st.table(91), st.table(92))
    assert bool(tt.eq_mask(
        tt.eval_lut(0xB4, outer, st.table(93), st.table(94)), target,
        tt.mask_table(8),
    ))


# -- one-line rejections ---------------------------------------------------


SHARED_REJECTIONS = [
    [],
    ["-a", "-123", DES],
    ["-a", "65536", DES],
    ["-i", "0", DES],
    ["-i", "-123", DES],
    ["-o", "-123", DES],
    ["-o", "8", DES],
    ["-p", "-123", DES],
    ["-p", "256", DES],
    ["-c", "-d", "test.xml"],
    ["-l", "-s", DES],
    ["-l", "nonexisting.txt"],
    ["-l", "-o", "7", DES],
    ["-l", "-o", "0", "-g", os.path.join(DATA, "des_s1.txt"), DES],
]


@pytest.mark.parametrize("argv", SHARED_REJECTIONS, ids=lambda a: " ".join(
    os.path.basename(x) for x in a) or "no-args")
def test_bad_flags_fail_with_the_jax_message(argv, capsys, tmp_path):
    from sboxgates_tpu.cli import main as jax_main

    out = ["--output-dir", str(tmp_path)] if argv else []
    capsys.readouterr()
    assert jax_main(argv + out) == 1
    want = capsys.readouterr().err.strip()
    assert cli.main(argv + out + ["--device", "cpu"]) == 1
    got = capsys.readouterr().err.strip()
    assert got == want
    assert got.count("\n") == 0 and got


@pytest.mark.parametrize("argv", [
    # --fleet-candidates without --fleet: the sweep runs as it would
    # without it; with it, the fleet's 8 shards split 2 x 4 (and 8 do not
    # split into 3, which both CLIs refuse in one line).
    ["-o", "0", "--seed", "1", "--fleet-candidates", "2", FA, FB],
    ["-o", "0", "--seed", "1", "--fleet", "--fleet-candidates", "4", FA, FB],
])
def test_unported_modes_fail_with_one_line(argv, capsys, tmp_path,
                                           monkeypatch):
    """The fleet-candidate modes run in the port on 8 shards and write the
    JAX CLI's files of its 8 devices (both in this process, on the native
    route)."""
    from sboxgates_tpu import native as jax_native
    from sboxgates_tpu.cli import main as jax_main

    monkeypatch.setenv("SBG_LOCAL_SHARDS", "8")
    monkeypatch.delenv("SBG_DISABLE_NATIVE", raising=False)
    if not jax_native.available():
        # This process's JAX package runs the device route: so does the
        # port.
        monkeypatch.setenv("SBG_DISABLE_NATIVE", "1")
    td, jd = str(tmp_path / "port"), str(tmp_path / "jax")
    assert cli.main(argv + ["--device", "cpu", "--output-dir", td]) == 0
    assert jax_main(argv + ["--output-dir", jd]) == 0
    want = {os.path.relpath(os.path.join(b, f), jd)
            for b, _, fs in os.walk(jd) for f in fs if f.endswith(".xml")}
    got = {os.path.relpath(os.path.join(b, f), td)
           for b, _, fs in os.walk(td) for f in fs if f.endswith(".xml")}
    assert got == want and got
    if "--fleet" in argv:
        bad = [a if a != "4" else "3" for a in argv]  # 8 shards by 3
        capsys.readouterr()
        assert cli.main(bad + ["--device", "cpu", "--output-dir",
                               str(tmp_path / "b")]) == 1
        err = capsys.readouterr().err.strip()
        assert err.count("\n") == 0 and "split" in err
        assert jax_main(bad + ["--output-dir", str(tmp_path / "jb")]) == 1
        assert capsys.readouterr().err.strip().splitlines()[-1] == err


def test_missing_card_is_an_error_not_a_cpu_run(capsys, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert Options().device == "cuda"
    with pytest.raises(RuntimeError, match="--device cpu"):
        SearchContext(Options(lut_graph=True))
    rc = cli.main(["-l", "-o", "0", "--output-dir", str(tmp_path), FA])
    assert rc == 1
    assert "torch.cuda.is_available() is false" in capsys.readouterr().err
    assert not os.listdir(tmp_path)


def test_verbose_run_prints_the_function_lists(capsys, tmp_path):
    rc = cli.main(["-l", "-o", "0", "-v", "-v", "--seed", "1", "--device", "cpu",
                   "--output-dir", str(tmp_path), FA])
    assert rc == 0
    out = capsys.readouterr().out
    assert out.startswith("Available gates: NOT AND XOR OR \n")
    assert "stats: " in out and "python_nodes=" in out
    names = sorted(os.listdir(tmp_path))
    assert len([n for n in names if n.endswith(".xml")]) == 1
    assert [n for n in names if not n.endswith(".xml")] == sorted(JOURNAL + TELEMETRY)
