"""The port's process group: several gloo ranks on the CPU against the JAX
package's goldens.

Each test starts its ranks as subprocesses joined at a free localhost port,
with a timeout of its own after which every rank is killed and reaped:

- the pod-wide worker (``tests/torch_mesh_worker.py pod``: the sharded
  pivot search, the chunked search with its compact gather, the engine's
  native-route agreement, the 7-LUT gather shape and a job-sharded
  permutation sweep) on 2 processes x 4 shards and 2 x 1, with the gather
  overflow (``SBG_GATHER_ROWS=1``) and with the native runtime off on rank
  1 only, against the JAX workers' lines on the same topologies;
- the replicated abort (``dispatch.sweep@rank:1`` hanging once or every
  window): both ranks print the same lines, the JAX workers';
- the CLI on 2 ranks x 1 shard (the planted G = 52 resume on the device
  route, the topology of the one card): rank 0 writes the JAX CLI's files;
- ``--permute-sweep --shard-sweep`` with rank 1 killed at its third round
  and both ranks resumed: the uninterrupted run's XML files.

Tolerance: exact equality (result lines, file bytes).
"""

import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch_mesh_goldens as mg  # noqa: E402

ROOT = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_mesh_worker.py")
#: Per-test limit of a pair of ranks (their CPU work is seconds).
TIMEOUT_S = 240


def _env(extra=None):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("SBG_", "JAX_", "XLA_"))}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    env.update(extra or {})
    return env


def _run(cmds, envs, cwd=ROOT, may_fail=()):
    """Starts every rank, waits up to TIMEOUT_S, kills and reaps whatever
    is left; returns (return codes, stdouts)."""
    procs = [subprocess.Popen(c, env=e, cwd=cwd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c, e in zip(cmds, envs)]
    outs, errs = [], []
    try:
        for p in procs:
            try:
                o, e = p.communicate(timeout=TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                o, e = p.communicate()
            outs.append(o)
            errs.append(e)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    rcs = [p.returncode for p in procs]
    for i, rc in enumerate(rcs):
        if i not in may_fail:
            assert rc == 0, (i, rcs, outs, errs)
    return rcs, outs


@pytest.mark.parametrize("case", ["pod_2x4_default", "pod_2x1_gather1",
                                  "pod_2x1_hetnative", "abort_2x1_transient",
                                  "abort_2x1_exhaust"])
def test_workers_match_the_jax_workers(case):
    worker, extra, env, env1, local, nproc = mg.WORKER_CASES[case]
    port = str(mg.free_port())
    cmds = [[sys.executable, WORKER, worker, str(i), port, str(local),
             str(nproc), *extra] for i in range(nproc)]
    envs = [_env(dict(env, **(env1 if i == 1 else {})))
            for i in range(nproc)]
    _, outs = _run(cmds, envs)
    lines = [mg.result_lines(o, worker) for o in outs]
    assert lines == mg.golden_lines(case)
    assert lines[0][:2] == lines[1][:2]
    if case.endswith("hetnative"):
        assert all("native=False" in " ".join(x) for x in lines)


def _cli_pair(argv, outdir, rank_env=None, may_fail=()):
    port = mg.free_port()
    cmds = [[sys.executable, "-m", "sboxgates_tpu_torch", *argv,
             "--device", "cpu", "--output-dir", outdir,
             "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
             "--process-id", str(i)] for i in range(2)]
    envs = [_env((rank_env or {}).get(i)) for i in range(2)]
    return _run(cmds, envs, may_fail=may_fail)


def test_two_rank_cli_writes_the_jax_clis_files(tmp_path):
    """Two ranks of one shard each: rank 0 writes the JAX CLI's files of
    the same two-process run; rank 1 writes none but its telemetry."""
    argv, env, devices, procs = mg.CLI_CASES["g52_p2x1_dev"]
    d = str(tmp_path / "run")
    _, outs = _cli_pair(argv, d, rank_env={0: env, 1: env})
    mg.compare_files("g52_p2x1_dev", d)
    assert "Generating graphs for output 0" in outs[0]
    assert outs[1] == ""
    assert sorted(os.listdir(os.path.join(d, "shard-01"))) == [
        "metrics.json", "telemetry.jsonl"]


def test_shard_sweep_killed_rank_resumes(tmp_path):
    """Rank 1 of a two-process ``--shard-sweep --permute-sweep`` run dies
    at its third round; ``--resume-run`` on two fresh ranks finishes it to
    the uninterrupted run's files (the JAX CLI's)."""
    from sboxgates_tpu_torch.resilience import faults

    argv, _, _, _ = mg.CLI_CASES["shard_sweep_p2"]
    d = str(tmp_path / "killed")
    rcs, _ = _cli_pair(argv, d, may_fail=(0, 1),
                       rank_env={1: {"SBG_FAULTS": "search.round:crash@3"}})
    assert rcs[1] == faults.CRASH_EXIT_CODE, rcs
    with pytest.raises(AssertionError):
        mg.compare_files("shard_sweep_p2", d, xml_only=True)
    _, outs = _cli_pair(["--resume-run", d], d)
    assert any("resumed" in o for o in outs), outs
    mg.compare_files("shard_sweep_p2", d, xml_only=True)
    assert all(o.startswith(f"[   {i}] ") for i, o in enumerate(outs))


@pytest.mark.slow
def test_golden_rederived_from_the_jax_workers(tmp_path):
    """The 2 x 1 pod golden written again by the JAX package's worker, live
    (``tests/torch_mesh_goldens.py``), equals the committed one."""
    case = "pod_2x1_default"
    want = mg.golden_lines(case)
    worker, extra, env, env1, local, nproc = mg.WORKER_CASES[case]
    jenv, src = mg.jax_env(local, env)
    jenv["PYTHONPATH"] = os.pathsep.join([src, HERE])
    path = str(tmp_path / "jax_worker.py")
    with open(path, "w") as f:
        f.write(mg.jax_worker_source(worker, local, nproc))
    port = str(mg.free_port())
    _, outs = _run([[sys.executable, path, str(i), port, *extra]
                    for i in range(nproc)], [jenv] * nproc)
    assert [mg.result_lines(o, worker) for o in outs] == want
