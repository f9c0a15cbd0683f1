"""Writes the journal goldens of chip_smoke.py's CLI runs with the JAX CLI.

For each entry of ``chip_smoke.JOURNAL_RUNS`` it runs the JAX package's CLI
on the CPU in a fresh process (its native route is chosen once per
process), with the entry's route (``SBG_DISABLE_NATIVE``) and faults
(``SBG_FAULTS``), resuming a crashed run with ``--resume-run``, and copies
the run's ``search.journal.jsonl`` and ``search.journal.json`` into
``tests/data/torch_golden/journal/<name>/`` with the checkout's root
written as ``chip_smoke.ROOT_MARK`` (the journal names its inputs by
absolute path; chip_smoke.py writes its own root back before comparing).
The entries with faults also get their XML files there.  Run from the root
of a checkout:

    python tests/torch_journal_goldens.py [name ...]

which needs the JAX package's requirements and takes a few minutes (the
gate-mode run on the device route takes most of it).
"""

import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def jax_cli(argv, native: bool, spec, cwd: str) -> int:
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu", SBG_WARMUP="0")
    env.pop("SBG_DISABLE_NATIVE", None)
    env.pop("SBG_FAULTS", None)
    if not native:
        env["SBG_DISABLE_NATIVE"] = "1"
    if spec:
        env["SBG_FAULTS"] = spec
    return subprocess.run([sys.executable, "-m", "sboxgates_tpu", *argv],
                          env=env, cwd=cwd).returncode


def write_golden(name: str, scratch: str) -> None:
    argv, native, spec, resumes = chip_smoke.JOURNAL_RUNS[name]
    d = os.path.join(scratch, name)
    rc = jax_cli([*argv, "--output-dir", d], native, spec, scratch)
    if resumes:
        if rc != 17:
            raise SystemExit(f"{name}: the crash run exited {rc}")
        rc = jax_cli(["--resume-run", d], native, None, scratch)
    if rc != 0:
        raise SystemExit(f"{name}: the JAX CLI exited {rc}")
    out = os.path.join(chip_smoke.JOURNAL_GOLDEN, name)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    for n in chip_smoke.JOURNAL_FILES:
        with open(os.path.join(d, n), encoding="utf-8") as f:
            text = f.read()
        with open(os.path.join(out, n), "w", encoding="utf-8") as f:
            f.write(text.replace(ROOT, chip_smoke.ROOT_MARK))
    if spec:
        for n in sorted(os.listdir(d)):
            if n.endswith(".xml"):
                shutil.copyfile(os.path.join(d, n), os.path.join(out, n))
    print(f"{name}: {sorted(os.listdir(out))}", flush=True)


def main(names) -> int:
    scratch = tempfile.mkdtemp(prefix="journal-goldens-")
    try:
        for name in names or chip_smoke.JOURNAL_RUNS:
            write_golden(name, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
