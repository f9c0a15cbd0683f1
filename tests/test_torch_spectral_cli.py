"""The port's ``--candidate-order`` CLI runs against the JAX package's CLI.

With the native runtime off in both packages (``SBG_DISABLE_NATIVE=1``,
the JAX runs in one fresh subprocess), the same spectral-order command writes
the same XML file, byte for byte: a G = 22 resume against a planted 7-LUT
(the 7-LUT stage A reordered), the G = 50 and G = 99 resumes against a
planted 5-LUT (the pivot tiles reordered).  DES S1 at seed 1 never reaches
an ordered stream, so its spectral run writes the lexicographic run's file,
which tests/test_torch_search.py holds against the JAX CLI (the JAX CLI's
spectral run writes the same bytes; its single-core run is left out here
for time).  The committed golden files are the ones chip_smoke.py holds
the card's runs to; the G = 22 inputs come from its generators.
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
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_golden")
DES = os.path.join(ROOT, "sboxes", "des_s1.txt")
G99_STATE = os.path.join(GOLDEN, "rijndael_g99_state.xml")
G99_SBOX = os.path.join(GOLDEN, "rijndael_planted_bit0.txt")
G22_STATE = os.path.join(GOLDEN, "rijndael_g22_state.xml")
G22_SBOX = os.path.join(GOLDEN, "rijndael_planted7_bit0.txt")


def _g50_argv(d):
    """The G = 50 pivot resume of tests/test_torch_search.py: its 5-LUT
    lies in the pivot sweep."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_search

    return test_torch_search._g50_argv(d)


SPECTRAL = ["--candidate-order", "spectral"]
CLI_CASES = {
    "des_s1_spectral": ["-l", "-o", "0", "--seed", "1", DES] + SPECTRAL,
    "g22_spectral": ["-l", "-o", "0", "--seed", "1", "-g", G22_STATE, G22_SBOX] + SPECTRAL,
    "g99_spectral": ["-l", "-o", "0", "--seed", "1", "-g", G99_STATE, G99_SBOX] + SPECTRAL,
}
GOLDEN_FILES = {
    "des_s1_spectral": "des_s1_l_o0_seed1.xml",
    "g22_spectral": "rijndael_planted7_l_o0_seed1_g22_spectral.xml",
    "g99_spectral": "rijndael_planted_l_o0_seed1_g99_spectral.xml",
}
#: Whether the run reaches an ordered stream.
ORDERED = {"des_s1_spectral": False, "g22_spectral": True, "g99_spectral": True,
           "g50_spectral": True}

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


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_cli_spectral")
    inputs = out / "inputs"
    inputs.mkdir()
    cases = {k: v for k, v in CLI_CASES.items() if k != "des_s1_spectral"}
    cases["g50_spectral"] = _g50_argv(str(inputs)) + SPECTRAL
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "") + " --xla_cpu_multi_thread_eigen=false"
    ).strip()
    core = max(os.sched_getaffinity(0))
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_DRIVER, json.dumps(cases), str(out)],
        cwd=str(out), env=env, capture_output=True, text=True, timeout=600,
        preexec_fn=lambda: os.sched_setaffinity(0, {core}),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    rcs = json.loads(proc.stdout.strip().splitlines()[-1])
    return out, rcs, cases


@pytest.mark.parametrize("name", sorted(ORDERED))
def test_spectral_cli_writes_the_jax_clis_file(name, jax_runs, tmp_path, capsys,
                                               monkeypatch):
    """The spectral searches write the JAX CLI's files byte for byte, with
    ordered dispatches (``order_tier_dispatches`` > 0) exactly where the
    run reaches an ordered stream; the committed golden files are those
    files."""
    out, rcs, cases = jax_runs
    monkeypatch.setenv("SBG_DISABLE_NATIVE", "1")  # the JAX runs' route
    rc = cli.main(dict(CLI_CASES, **cases)[name] + [
        "--device", "cpu", "-v", "-v", "--output-dir", str(tmp_path)])
    assert rc == 0
    stats = dict(kv.split("=") for kv in capsys.readouterr().out.split(
        "stats: ")[1].splitlines()[0].split())
    assert (int(stats.get("order_tier_dispatches", 0)) > 0) == ORDERED[name]
    got = _xml_files(str(tmp_path))
    if name in rcs:
        assert rcs[name] == 0
        assert got and got == _xml_files(os.path.join(out, name))
        # The journal records candidate_order: the JAX CLI's bytes too.
        for n in ("search.journal.jsonl", "search.journal.json"):
            with open(os.path.join(out, name, n), "rb") as a, \
                    open(os.path.join(str(tmp_path), n), "rb") as b:
                assert a.read() == b.read(), n
    if name in GOLDEN_FILES:
        with open(os.path.join(GOLDEN, GOLDEN_FILES[name]), "rb") as f:
            assert list(got.values()) == [f.read()]


def test_bad_candidate_order_fails_with_the_jax_message(capsys, tmp_path):
    from sboxgates_tpu.cli import main as jax_main

    argv = ["-l", "-o", "0", "--candidate-order", "bogus",
            "--output-dir", str(tmp_path), os.path.join(ROOT, "sboxes", "des_s1.txt")]
    capsys.readouterr()
    assert jax_main(argv) == 1
    want = capsys.readouterr().err.strip()
    assert cli.main(argv + ["--device", "cpu"]) == 1
    got = capsys.readouterr().err.strip()
    assert got == want == "Bad candidate order value: bogus"


def test_options_reject_an_unknown_order():
    from sboxgates_tpu_torch.search import Options, SearchContext

    with pytest.raises(ValueError, match="candidate order"):
        SearchContext(Options(device="cpu", candidate_order="bogus"))


def test_g22_inputs_come_from_chip_smokes_generators():
    """The committed G = 22 state and planted S-box are planted7_state and
    planted7_sbox (tests/torch_states.py, the constructions chip_smoke.py
    keeps a copy of), as the port saves them, and output bit 0 is the
    planted 7-LUT."""
    from sboxgates_tpu_torch.core import ttable as tt
    from sboxgates_tpu_torch.graph.xmlio import state_to_xml
    from sboxgates_tpu_torch.resilience.checkpoint import with_digest

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_states import planted7_sbox, planted7_state

    st = planted7_state()
    with open(G22_STATE) as f:
        assert f.read() == with_digest(state_to_xml(st))
    sbox = planted7_sbox(st)
    with open(G22_SBOX) as f:
        assert f.read() == " ".join("%02x" % v for v in sbox) + "\n"
    outer = tt.eval_lut(0x96, st.table(9), st.table(12), st.table(17))
    middle = tt.eval_lut(0xE8, st.table(10), st.table(15), st.table(21))
    assert bool(tt.eq_mask(tt.eval_lut(0xCA, outer, middle, st.table(19)),
                           tt.target_table(sbox, 0), tt.mask_table(8)))
