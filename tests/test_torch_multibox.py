"""The job axis of the port, part 2: several S-box files and permutation
sweeps through the CLI.

Each command's run directory (per-box and ``pXX/`` subdirectories, every
XML file, the run journal and the per-box journals) is held byte for byte
against the JAX CLI's for the same command (goldens made by
``tests/torch_job_goldens.py``; cases in ``tests/torch_cli_helpers.py``).
The validation messages of the new flags are held against the JAX CLI's,
run in this process.  Resume: a run the JAX CLI journaled and was killed
in, finished by the port; and the port's own killed permutation sweep,
finished by the port.  Tolerance: exact bytes.
"""

import os
import subprocess
import sys

import pytest

from torch_cli_helpers import (
    ROOT,
    box,
    compare_run,
    copy_golden,
    environ,
    golden_case,
    run_files,
    run_port_cli,
)


@pytest.mark.parametrize("case", [
    "mb_des12_lut_o0", "mb_des12_lut_o0_serial", "mb_crypto_all",
    "mb_crypto_all_serial", "ps_crypto1_fa_o0", "ps_crypto1_fb_all_batched",
    "mb_des8_lut_o0",
])
def test_sweep_writes_the_jax_clis_files(case, tmp_path):
    argv, env = golden_case(case)
    run_port_cli(argv, env, str(tmp_path / "d"))
    compare_run(case, str(tmp_path / "d"))


def test_warmup_and_compile_cache_flags_change_nothing(tmp_path):
    """``--no-warmup`` and ``--compile-cache DIR`` are accepted for the JAX
    CLI's command lines and change no file (neither is journaled, as in
    the JAX CLI); the port creates no cache directory."""
    argv, env = golden_case("mb_crypto_all")
    cache = tmp_path / "cache"
    run_port_cli(argv, env, str(tmp_path / "d"),
                 extra=["--no-warmup", "--compile-cache", str(cache)])
    compare_run("mb_crypto_all", str(tmp_path / "d"))
    assert not cache.exists()


FA, FB = box("crypto1_fa"), box("crypto1_fb")


@pytest.mark.parametrize("argv", [
    ["--permute-sweep", "-o", "0", FA, FB],
    ["--permute-sweep", "-o", "0", "-g", "x.xml", FA],
    ["--permute-sweep", "-p", "3", "-o", "0", FA],
    ["--fleet", "--serial-jobs", "-o", "0", FA, FB],
    ["--fleet-max-wave", "0", "-o", "0", FA],
    ["--fleet-candidates", "0", "-o", "0", FA],
    ["-c", FA, FB],
    ["-g", "x.xml", "-o", "0", FA, FB],
    ["-o", "3", FA, FB],
    ["-o", "2", box("des_s1"), FA],
    ["--permute-sweep", "-i", "0", FA],
])
def test_validation_messages_match_the_jax_cli(argv, tmp_path, capsys):
    from sboxgates_tpu import cli as jcli

    from sboxgates_tpu_torch import cli as tcli

    assert jcli.main([*argv, "--output-dir", str(tmp_path / "j")]) == 1
    want = capsys.readouterr().err.strip().splitlines()[-1]
    assert tcli.main([*argv, "--device", "cpu", "--output-dir",
                      str(tmp_path / "t")]) == 1
    got = capsys.readouterr().err.strip().splitlines()[-1]
    assert got == want


def test_jax_journaled_killed_sweep_resumes_in_the_port(tmp_path):
    """The JAX CLI's serial multi-box run, killed at its third checkpoint
    write (its per-box journals hold the finished attempts), resumed by
    the port: the uninterrupted run's files."""
    d = str(tmp_path / "d")
    copy_golden("mb_crypto_all_killed", d)
    from sboxgates_tpu_torch import cli

    with environ({}):
        assert cli.main(["--resume-run", d, "--device", "cpu"]) == 0
    compare_run("mb_crypto_all_serial", d)


def _port_process(argv, env):
    e = dict(os.environ, PYTHONPATH=ROOT)
    for k in ("SBG_DISABLE_NATIVE", "SBG_FAULTS", "SBG_ENGINE_MUX_THREADS"):
        e.pop(k, None)
    e.update(env)
    return subprocess.run(
        [sys.executable, "-m", "sboxgates_tpu_torch", *argv, "--device", "cpu"],
        env=e, capture_output=True, text=True,
    ).returncode


def test_killed_permute_sweep_resumes_to_the_uninterrupted_files(tmp_path):
    """A real crash (``os._exit``) after the fifth permutation's journal
    record, then ``--resume-run``: the JAX CLI's uninterrupted files."""
    argv, env = golden_case("ps_crypto1_fa_o0")
    d = str(tmp_path / "d")
    assert _port_process([*argv, "--output-dir", d],
                         dict(env, SBG_FAULTS="search.round:crash@5")) == 17
    assert 0 < len([r for r in run_files(d) if r.endswith(".xml")]) < 16
    assert _port_process(["--resume-run", d], env) == 0
    compare_run("ps_crypto1_fa_o0", d)
