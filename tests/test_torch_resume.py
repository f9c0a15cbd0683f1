"""Kill and resume of the port's CLI, against the JAX CLI's files.

A search killed at a fault site and continued with ``--resume-run`` ends
with the XML files and the journal (``search.journal.jsonl`` and
``search.journal.json``) of an uninterrupted JAX CLI run with the same
command, byte for byte, on the default (native) route:

- the three kill points of the JAX package's tests/test_resume.py
  (``ckpt.write@3``, ``search.round@2``, ``search.node@7``) on DES S1,
  full graph, ``--seed 11``, interrupted in process with ``raise`` (the same
  files on disk as a crash);
- the one-output driver (``-o 0 -i 2``, ``ckpt.write@2``);
- a run the JAX CLI journaled and was killed in (``search.round@2``),
  resumed by the port.

Resuming a finished run does nothing, and a journal the port cannot resume
is refused in one line with rc 1 (the JAX CLI's message where it has one).
The JAX runs share one fresh subprocess: that package picks its native
route once per process.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from sboxgates_tpu_torch import cli
from sboxgates_tpu_torch.resilience import faults
from sboxgates_tpu_torch.resilience.journal import JOURNAL_NAME, SNAPSHOT_NAME

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
DES = os.path.join(DATA, "des_s1.txt")
FA = os.path.join(DATA, "crypto1_fa.txt")
SEED = "11"
FULL = [DES, "--seed", SEED]
ONE = [DES, "-o", "0", "-i", "2", "--seed", SEED]
KILL_POINTS = [("ckpt.write", "3"), ("search.round", "2"), ("search.node", "7")]

# The JAX CLI on each case of argv[1] (JSON: name -> [argv, fault or
# null]) into argv[2]/<name>; a case with a fault is killed by it.
_JAX_RUNS = r"""
import json, os, sys
from sboxgates_tpu import native
from sboxgates_tpu.cli import main
from sboxgates_tpu.resilience import faults
if not native.available():
    sys.exit(f"native runtime unavailable: {native.build_error()}")
rcs = {}
for name, (argv, fault) in json.loads(sys.argv[1]).items():
    if fault:
        faults.arm(*fault)
    try:
        rcs[name] = main(argv + ["--output-dir", os.path.join(sys.argv[2], name)])
    except faults.InjectedFault:
        rcs[name] = "killed"
    faults.disarm()
print(json.dumps(rcs))
"""


def _is_result(name):
    return name.endswith(".xml") or name in (JOURNAL_NAME, SNAPSHOT_NAME)


def _files(d):
    """The XML files and the journal of a run directory."""
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d)) if _is_result(n)}


# The JAX CLI's persistent XLA compile cache of an explicit --output-dir:
# the port compiles no XLA and has none.
JAX_ONLY = ("xla_cache",)


def _others(d):
    return sorted(n for n in os.listdir(d)
                  if not _is_result(n) and n not in JAX_ONLY)


def _port_files(d, jax_runs):
    """As :func:`_files`, for a directory of a port run killed once: its
    other files must be those of the JAX CLI's run directory killed the
    same way (the heartbeat, ``metrics.json`` and the fatal exception's
    flight dump), and nothing else."""
    assert _others(d) == _others(os.path.join(jax_runs, "killed"))
    return _files(d)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_resume")
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu", SBG_WARMUP="0")
    env.pop("SBG_DISABLE_NATIVE", None)
    env.pop("SBG_FAULTS", None)
    cases = {"full": [FULL, None], "one": [ONE, None],
             "killed": [FULL, ["search.round", "raise", "2"]]}
    core = max(os.sched_getaffinity(0))
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_RUNS, json.dumps(cases), str(out)],
        cwd=str(out), env=env, capture_output=True, text=True, timeout=600,
        preexec_fn=lambda: os.sched_setaffinity(0, {core}),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    rcs = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rcs == {"full": 0, "one": 0, "killed": "killed"}, rcs
    return out


@pytest.fixture(autouse=True)
def _port_env(monkeypatch):
    monkeypatch.delenv("SBG_DISABLE_NATIVE", raising=False)
    faults.disarm()
    yield
    faults.disarm()


def _main(argv):
    return cli.main(argv + ["--device", "cpu"])


def _killed(argv, d, site, when):
    faults.arm(site, "raise", when)
    try:
        with pytest.raises(faults.InjectedFault):
            _main(argv + ["--output-dir", d])
    finally:
        faults.disarm()


@pytest.mark.parametrize("site,when", KILL_POINTS)
def test_killed_search_resumes_to_the_jax_clis_files(site, when, tmp_path,
                                                    jax_runs, capsys):
    d = str(tmp_path)
    _killed(FULL, d, site, when)
    want = _files(os.path.join(jax_runs, "full"))
    assert _port_files(d, jax_runs) != want
    assert _main(["--resume-run", d]) == 0
    assert _port_files(d, jax_runs) == want
    capsys.readouterr()
    # A finished run resumes as a no-op.
    assert _main(["--resume-run", d]) == 0
    assert "already complete; nothing to resume" in capsys.readouterr().out
    assert _port_files(d, jax_runs) == want


def test_one_output_driver_resumes_to_the_jax_clis_files(tmp_path, jax_runs):
    d = str(tmp_path)
    _killed(ONE, d, "ckpt.write", "2")
    assert _main(["--resume-run", d]) == 0
    assert _port_files(d, jax_runs) == _files(os.path.join(jax_runs, "one"))


def test_run_the_jax_cli_journaled_resumes_in_the_port(tmp_path, jax_runs):
    d = str(tmp_path / "killed")
    shutil.copytree(os.path.join(jax_runs, "killed"), d)
    assert _files(d) != _files(os.path.join(jax_runs, "full"))
    assert _main(["--resume-run", d]) == 0
    assert _files(d) == _files(os.path.join(jax_runs, "full"))


def _journal_with(tmp_path, name, **config):
    """A journal of a short port run, its recorded configuration changed
    by ``config`` (a value of ``...`` drops the key)."""
    d = str(tmp_path / name)
    assert _main(["-o", "0", "--seed", "1", "--output-dir", d, FA]) == 0
    path = os.path.join(d, JOURNAL_NAME)
    recs = [json.loads(line) for line in open(path)]
    recs = recs[:1]  # an unfinished run
    for k, v in config.items():
        if k == "version":
            recs[0]["version"] = v
        elif v is ...:
            del recs[0]["config"][k]
        else:
            recs[0]["config"][k] = v
    with open(path, "w") as f:
        f.writelines(json.dumps(r, sort_keys=True) + "\n" for r in recs)
    os.unlink(os.path.join(d, SNAPSHOT_NAME))
    return d


REFUSALS = {
    "version": dict(version=3),
    "missing_key": dict(pipeline_depth=...),
    # A mesh, a fleet split over 4 x 2 shards and batched restarts on a
    # mesh resume in the port, to the JAX CLI's files (8 shards, its 8
    # devices); a sweep sharded over processes with one input, and a
    # several-input one that records no process count, are refused by both
    # CLIs with the JAX CLI's line.
    "mesh": dict(mesh=True),
    "fleet": dict(fleet=True, fleet_candidates=2),
    "serve": dict(serve=True),
    # A serve run with the HTTP front door resumes by serving again too.
    "serve_port": dict(serve=True, serve_port=0,
                       serve_token_file="tokens.json"),
    "batch_iterations": dict(batch_iterations=True, mesh=True),
    "shard_sweep": dict(shard_sweep=True),
    "several_inputs": dict(input=[FA, FA], shard_sweep=True),
}
# The journals both CLIs resume (the rest both refuse, in one line).
RESUMED = ("mesh", "fleet", "batch_iterations")

# The JAX CLI resuming each directory of argv[1:] on 8 virtual devices, in
# a fresh process on its native route.
_JAX_RESUME = r"""
import sys
from sboxgates_tpu import native
from sboxgates_tpu.cli import main
if not native.available():
    sys.exit(f"native runtime unavailable: {native.build_error()}")
for d in sys.argv[1:]:
    assert main(["--resume-run", d]) == 0, d
"""


def _jax_resume(dirs):
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               SBG_WARMUP="0",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    for k in ("SBG_DISABLE_NATIVE", "SBG_FAULTS", "SBG_LOCAL_SHARDS"):
        env.pop(k, None)
    subprocess.run([sys.executable, "-c", _JAX_RESUME, *dirs], env=env,
                   check=True, timeout=600, stdout=subprocess.DEVNULL)


def _files(d):
    out = {}
    for f in sorted(os.listdir(d)):
        if f.endswith(".xml") or "journal" in f:
            with open(os.path.join(d, f), "rb") as fh:
                out[f] = fh.read()
    return out


@pytest.mark.parametrize("case", sorted(REFUSALS) + ["no_journal"])
def test_a_journal_the_port_cannot_resume_is_refused_in_one_line(
        case, tmp_path, capsys, monkeypatch):
    """Each journal is refused by the port with the JAX CLI's line, or,
    for the modes the port runs (RESUMED), resumed by both CLIs to the
    same files."""
    if case == "no_journal":
        d = str(tmp_path / "empty")
        os.makedirs(d)
    else:
        d = _journal_with(tmp_path, case, **REFUSALS[case])
    if case in RESUMED:
        jd = _copy_run(d, str(tmp_path / "jax"))
        monkeypatch.setenv("SBG_LOCAL_SHARDS", "8")
        assert _main(["--resume-run", d]) == 0
        _jax_resume([jd])
        assert _files(d) == _files(jd)
        assert any(f.endswith(".xml") for f in _files(d))
        return
    before = sorted(os.listdir(d))
    assert _main(["--resume-run", d]) == 1
    err = capsys.readouterr().err.strip()
    assert err.count("\n") == 0 and err
    assert sorted(os.listdir(d)) == before
    from sboxgates_tpu import cli as jcli

    assert jcli.main(["--resume-run", d]) == 1
    assert capsys.readouterr().err.strip().splitlines()[-1] == err


def _copy_run(src, dst):
    shutil.copytree(src, dst)
    return dst


@pytest.mark.parametrize("case", ["chain_rounds", "result_store"])
def test_a_chain_or_store_journal_resumes(case, tmp_path, monkeypatch):
    """A killed ``--chain-rounds`` run resumes to the JAX CLI's files (the
    golden of tests/torch_round_goldens.py), and a killed
    ``--result-store`` run to the uninterrupted run's files, in the port
    and in the JAX CLI alike, publishing to the journaled store."""
    from sboxgates_tpu import cli as jcli

    import torch_round_goldens as goldens

    monkeypatch.chdir(tmp_path)
    if case == "chain_rounds":
        argv = ["-l", "--chain-rounds", "4", "--seed", "1",
                goldens.planted_path()]
        _killed(argv, "d", "journal.append", "4")
        assert _main(["--resume-run", "d"]) == 0
        goldens.compare_dir(goldens.golden_dir("planted_n4"), "d")
        return
    argv = ["-l", "-o", "0", "-i", "2", "--seed", SEED, "--result-store", "S",
            DES]
    assert _main(argv + ["--output-dir", "full"]) == 0
    _killed(argv, "d", "journal.append", "2")
    _copy_run("d", "d_jax")
    assert _main(["--resume-run", "d"]) == 0
    assert _files("d") == _files("full")
    assert jcli.main(["--resume-run", "d_jax"]) == 0
    assert _files("d_jax") == _files("full")
    assert os.listdir(os.path.join("S", "objects"))
