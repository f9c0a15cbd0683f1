"""Writes the goldens of the port's mesh and multi-process cases with the
JAX package, and holds the port's runs against them.

``CLI_CASES`` are CLI runs: the JAX CLI on the CPU in fresh processes, each
with ``devices`` virtual devices (``--xla_force_host_platform_device_count``)
and, for ``procs`` > 1, joined into one runtime with ``--coordinator``.  The
run directory's XML files and journals go to
``tests/data/torch_golden/mesh/<case>/``, the checkout root written
``@ROOT@`` in the journals.  The port runs the same command with
``SBG_LOCAL_SHARDS=<devices>`` (and ``procs`` gloo ranks).

``WORKER_CASES`` are the JAX package's multi-process test workers
(``tests/distributed_worker.py``, ``tests/distributed_degrade_worker.py``)
run on a topology of ``procs`` processes x ``devices`` local devices: their
result lines, rank field dropped, go to ``<case>/lines.json`` for the
port's workers (``tests/torch_mesh_worker.py``) to match.

From the root of a checkout (needs the JAX package's requirements; about
twenty minutes for all cases on the CPU):

    python tests/torch_mesh_goldens.py [case ...]

``JAX_SOURCE=DIR`` runs the JAX package from ``DIR`` (a ``git archive`` of
the checkout), so that its native library builds there and not in the
checkout.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_cli_helpers import (  # noqa: E402
    DES,
    DEV,
    G99_BOX,
    G99_STATE,
    ROOT,
    box,
    marked,
    run_files,
)

GOLDEN = os.path.join(ROOT, "tests", "data", "torch_golden", "mesh")
DATA = os.path.join(ROOT, "tests", "data")
FA = os.path.join(DATA, "crypto1_fa.txt")
FB = os.path.join(DATA, "crypto1_fb.txt")
FC = os.path.join(DATA, "crypto1_fc.txt")
#: A 52-gate state whose output-0 node reaches the pivot sweep in its
#: first tiles (``torch_states.random_state(52, 11)``, the planted 5-LUT
#: over gates 40, 42, 44, 47, 50).
G52_STATE = os.path.join(GOLDEN, "g52_state.xml")
G52_BOX = os.path.join(GOLDEN, "g52_bit0.txt")
DES_S1 = box("des_s1")

_LUT_O0 = ["--mesh", "-l", "-o", "0", "--seed"]

#: case -> (argv without --output-dir, environment, devices per process,
#: processes).
CLI_CASES = {
    "crypto1_fa_d8": ([*_LUT_O0, "11", FA], {}, 8, 1),
    "crypto1_fa_d8_dev": ([*_LUT_O0, "11", FA], DEV, 8, 1),
    "g52_d8": ([*_LUT_O0, "1", "-g", G52_STATE, G52_BOX], {}, 8, 1),
    "g52_d8_dev": ([*_LUT_O0, "1", "-g", G52_STATE, G52_BOX], DEV, 8, 1),
    "des_s1_d8": ([*_LUT_O0, "1", DES_S1], {}, 8, 1),
    "des_s1_d8_dev": ([*_LUT_O0, "1", DES_S1], DEV, 8, 1),
    # chip_smoke.py phase 14: two shards of one card, two ranks on it.
    "g99_d2_dev": ([*_LUT_O0, "1", "-g", G99_STATE, G99_BOX], DEV, 2, 1),
    "des_s1_d2_dev": ([*_LUT_O0, "1", DES_S1], DEV, 2, 1),
    "g99_p2x1_dev": (["-l", "-o", "0", "--seed", "1", "-g", G99_STATE,
                      G99_BOX], DEV, 1, 2),
    "g52_p2x1_dev": (["-l", "-o", "0", "--seed", "1", "-g", G52_STATE,
                      G52_BOX], DEV, 1, 2),
    # chip_smoke.py --cards (phase 15, run by hand; no test reads these)
    # on four cards: one process over the four, and four processes of one
    # card each.
    "g99_d4_dev": ([*_LUT_O0, "1", "-g", G99_STATE, G99_BOX], DEV, 4, 1),
    "g99_p4x1_dev": (["-l", "-o", "0", "--seed", "1", "-g", G99_STATE,
                      G99_BOX], DEV, 1, 4),
    # the job-sharded permutation sweep (its kill and resume are the
    # port's; the golden is the uninterrupted run) and the fleet mesh
    "shard_sweep_p2": (["--permute-sweep", "--shard-sweep", "-o", "0", "-l",
                        "--seed", "7", FA], {}, 1, 2),
    "fleet_c2_d2_dev": (["--fleet", "--fleet-candidates", "2", "-o", "0",
                         "--seed", "7", FA, FB, FC], DEV, 2, 1),
    "fleet_c2_d8": (["--fleet", "--fleet-candidates", "2", "-l", "-o", "0",
                     "--seed", "1", FA, FB, FC], {}, 8, 1),
    # Fleets of four job shards on the device route (chip_smoke.py 14f on
    # four shards of one card, 15d on four cards, and
    # tests/test_torch_fleet_shards.py): the DES-8 fleet runs K3's lane
    # form, the G = 99 resume's 8 restarts K1's.
    "fleet_des8_d4_dev": (["--fleet", "-l", "-o", "0", "--seed", "1", *DES],
                          DEV, 4, 1),
    "fleet_g99_i8_d4_dev": (["--fleet", "-l", "-o", "0", "-i", "8", "--seed",
                             "1", "-g", G99_STATE, G99_BOX], DEV, 4, 1),
    # The same fleets on two candidate shards per job shard: 4 x 2 at 8
    # devices (chip_smoke.py 14h on eight shards of one card, and
    # tests/test_torch_fleet_candidates.py) and 2 x 2 at 4 devices
    # (chip_smoke.py 15e on four cards).
    "fleet_des8_c2_d8_dev": (["--fleet", "--fleet-candidates", "2", "-l",
                              "-o", "0", "--seed", "1", *DES], DEV, 8, 1),
    "fleet_g99_i8_c2_d8_dev": (["--fleet", "--fleet-candidates", "2", "-l",
                                "-o", "0", "-i", "8", "--seed", "1", "-g",
                                G99_STATE, G99_BOX], DEV, 8, 1),
    "fleet_des8_c2_d4_dev": (["--fleet", "--fleet-candidates", "2", "-l",
                              "-o", "0", "--seed", "1", *DES], DEV, 4, 1),
    "fleet_g99_i8_c2_d4_dev": (["--fleet", "--fleet-candidates", "2", "-l",
                                "-o", "0", "-i", "8", "--seed", "1", "-g",
                                G99_STATE, G99_BOX], DEV, 4, 1),
}

#: case -> (worker, extra argv, environment of every rank, environment of
#: rank 1 only, devices per process, processes).
WORKER_CASES = {
    "pod_2x4_default": ("pod", [], {}, {}, 4, 2),
    "pod_2x1_default": ("pod", [], {}, {}, 1, 2),
    "pod_2x1_gather1": ("pod", [], {"SBG_GATHER_ROWS": "1"}, {}, 1, 2),
    "pod_2x1_hetnative": ("pod", [], {}, {"SBG_DISABLE_NATIVE": "1"}, 1, 2),
    "abort_2x1_transient": ("degrade", ["transient"], {}, {}, 1, 2),
    "abort_2x1_exhaust": ("degrade", ["exhaust"], {}, {}, 1, 2),
}

#: The JAX workers' result lines, by worker.
WORKER_PREFIXES = {
    "pod": ("RESULT", "RESULT2", "STREAMCHECK", "ENGINE", "STREAMCHECK7",
            "SWEEP"),
    "degrade": ("REF", "DEGRADE"),
}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def golden_dir(case) -> str:
    return os.path.join(GOLDEN, case)


def result_lines(out: str, worker: str):
    """The worker's result lines of one rank's output, rank field dropped,
    in print order."""
    keep = []
    for line in out.splitlines():
        parts = line.split()
        if parts and parts[0] in WORKER_PREFIXES[worker]:
            keep.append(" ".join([parts[0], *parts[2:]]))
    return keep


def golden_lines(case):
    """[rank 0's lines, rank 1's lines] of a worker case."""
    with open(os.path.join(golden_dir(case), "lines.json")) as f:
        return json.load(f)


def compare_files(case, d, xml_only=False):
    """The run directory ``d`` holds the golden's files byte for byte
    (journals with the root marked); ``xml_only`` compares the XML files
    only (a resumed run's journals carry its resume records)."""
    def keep(rel):
        return rel.endswith(".xml") or not xml_only

    want = {r: b for r, b in run_files(golden_dir(case)).items()
            if keep(r) and r != "lines.json"}
    got = {r: marked(b, r) for r, b in run_files(d).items() if keep(r)}
    assert sorted(got) == sorted(want), (case, sorted(got), sorted(want))
    for rel in want:
        assert got[rel] == want[rel], (case, rel)


def jax_env(devices, extra):
    src = os.environ.get("JAX_SOURCE", ROOT)
    env = dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu",
               SBG_WARMUP="0",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    for k in ("SBG_DISABLE_NATIVE", "SBG_FAULTS", "SBG_ENGINE_MUX_THREADS",
              "SBG_GATHER_ROWS", "JAX_COORDINATOR_ADDRESS"):
        env.pop(k, None)
    env.update(extra)
    return env, src


def _run_ranks(cmds, envs, cwd, timeout=1800):
    procs = [subprocess.Popen(c, env=e, cwd=cwd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c, e in zip(cmds, envs)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [p.returncode for p in procs], outs


def write_cli_golden(case, scratch) -> None:
    argv, env, devices, procs = CLI_CASES[case]
    d = os.path.join(scratch, case)
    os.makedirs(d)
    jenv, _ = jax_env(devices, env)
    base = [sys.executable, "-m", "sboxgates_tpu", *argv, "--output-dir", d]
    if procs == 1:
        cmds = [base]
    else:
        port = free_port()
        cmds = [[*base, "--coordinator", f"127.0.0.1:{port}",
                 "--num-processes", str(procs), "--process-id", str(i)]
                for i in range(procs)]
    rcs, outs = _run_ranks(cmds, [jenv] * procs, scratch)
    if any(rcs):
        raise SystemExit(f"{case}: the JAX CLI exited {rcs}:\n{outs}")
    out = golden_dir(case)
    shutil.rmtree(out, ignore_errors=True)
    for rel, data in run_files(d).items():
        p = os.path.join(out, rel)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "wb") as f:
            f.write(marked(data, rel))
    print(f"{case}: {len(run_files(out))} files", flush=True)


def jax_worker_source(worker, devices, procs) -> str:
    """The JAX package's test worker for ``devices`` local devices per
    process (its own file pins 4)."""
    src_root = os.environ.get("JAX_SOURCE", ROOT)
    name = ("distributed_worker.py" if worker == "pod"
            else "distributed_degrade_worker.py")
    with open(os.path.join(src_root, "tests", name)) as f:
        src = f.read()
    src = src.replace("device_count=4", f"device_count={devices}")
    src = src.replace("len(jax.devices()) == 8",
                      f"len(jax.devices()) == {devices * procs}")
    # It reads its inputs next to itself: point it at the checkout's.
    return src.replace("os.path.dirname(__file__)",
                       repr(os.path.join(src_root, "tests")))


def write_worker_golden(case, scratch) -> None:
    worker, extra, env, env1, devices, procs = WORKER_CASES[case]
    jenv, src_root = jax_env(devices, env)
    path = os.path.join(scratch, f"{case}_worker.py")
    with open(path, "w") as f:
        f.write(jax_worker_source(worker, devices, procs))
    jenv["PYTHONPATH"] = os.pathsep.join([src_root,
                                          os.path.join(src_root, "tests")])
    port = str(free_port())
    cmds = [[sys.executable, path, str(i), port, *extra]
            for i in range(procs)]
    envs = [dict(jenv, **(env1 if i == 1 else {})) for i in range(procs)]
    rcs, outs = _run_ranks(cmds, envs, scratch)
    if any(rcs):
        raise SystemExit(f"{case}: the JAX worker exited {rcs}:\n{outs}")
    lines = [result_lines(o, worker) for o in outs]
    out = golden_dir(case)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "lines.json"), "w") as f:
        json.dump(lines, f, indent=1)
        f.write("\n")
    print(f"{case}: {lines}", flush=True)


def main(names) -> int:
    os.makedirs(GOLDEN, exist_ok=True)
    scratch = tempfile.mkdtemp(prefix="mesh-goldens-")
    try:
        for case in names or [*CLI_CASES, *WORKER_CASES]:
            if case in CLI_CASES:
                write_cli_golden(case, scratch)
            else:
                write_worker_golden(case, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
