"""Writes the goldens of the job-axis CLI cases with the JAX CLI.

For each case of ``torch_cli_helpers.CASES`` it runs the JAX package's CLI
on the CPU in a fresh process (its native route is chosen once per
process), with the case's environment, ``--output-dir`` in a scratch
directory, and — for a case marked ``mux`` — ``Options.parallel_mux``
resolved on as on an accelerator (a ``SearchContext.__init__`` wrapper in
the child: it turns the ``None`` default into ``True`` and touches nothing
else, so the batched rendezvous' padding rule and the attribution backend
keep their CPU values; neither changes a file).  A case with a crash spec
runs under ``SBG_FAULTS`` and must exit 17; its golden is the directory
the crash left.  The run directory's XML files and journals are copied to
``tests/data/torch_golden/jobs/<case>/``, the checkout root written as
``@ROOT@`` in the journals.  From the root of a checkout:

    python tests/torch_job_goldens.py [case ...]

which needs the JAX package's requirements; all cases take about ten
minutes on the CPU.
"""

import os
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_cli_helpers import (  # noqa: E402
    CASES,
    GOLDEN,
    ROOT,
    golden_dir,
    marked,
    run_files,
)

_MUX = (
    "import sys\n"
    "from sboxgates_tpu.search import context as C\n"
    "_init = C.SearchContext.__init__\n"
    "def init(self, opt, *a, **k):\n"
    "    if opt.parallel_mux is None:\n"
    "        opt.parallel_mux = True\n"
    "    _init(self, opt, *a, **k)\n"
    "C.SearchContext.__init__ = init\n"
    "from sboxgates_tpu import cli\n"
    "sys.exit(cli.main(sys.argv[1:]))\n"
)


def jax_cli(argv, env_extra, mux, cwd) -> int:
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu", SBG_WARMUP="0")
    for k in ("SBG_DISABLE_NATIVE", "SBG_FAULTS", "SBG_ENGINE_MUX_THREADS"):
        env.pop(k, None)
    env.update(env_extra)
    cmd = [sys.executable, "-c", _MUX] if mux else [
        sys.executable, "-m", "sboxgates_tpu"]
    return subprocess.run([*cmd, *argv], env=env, cwd=cwd).returncode


def write_golden(case, scratch) -> None:
    argv, env, mux, crash = CASES[case]
    d = os.path.join(scratch, case)
    env = dict(env)
    if crash:
        env["SBG_FAULTS"] = crash
    rc = jax_cli([*argv, "--output-dir", d], env, mux, scratch)
    if rc != (17 if crash else 0):
        raise SystemExit(f"{case}: the JAX CLI exited {rc}")
    out = golden_dir(case)
    shutil.rmtree(out, ignore_errors=True)
    for rel, data in run_files(d).items():
        p = os.path.join(out, rel)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "wb") as f:
            f.write(marked(data, rel))
    print(f"{case}: {len(run_files(out))} files", flush=True)


def main(names) -> int:
    os.makedirs(GOLDEN, exist_ok=True)
    scratch = tempfile.mkdtemp(prefix="job-goldens-")
    try:
        for case in names or CASES:
            write_golden(case, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
