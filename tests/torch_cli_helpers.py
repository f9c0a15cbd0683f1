"""Goldens of the job-axis CLI runs, and the port's runs held against them.

``CASES`` names each command once: the JAX CLI's run of it (made by
``tests/torch_job_goldens.py``, stored under
``tests/data/torch_golden/jobs/<case>/``) and the port's run in the tests.
A golden holds the run directory's XML files (per-box and ``pXX/``
subdirectories included) and journals, with the checkout root written
``@ROOT@`` in the journals (they name the inputs by absolute path).

``mux`` marks a case made with the JAX package's mux resolved on, as on an
accelerator (``Options.parallel_mux`` None -> True): the port runs it with
``parallel_mux=True``, which is what ``--device cuda`` resolves to.
"""

import contextlib
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_golden", "jobs")
ROOT_MARK = "@ROOT@"

#: Names a run directory holds besides the search's own files: telemetry
#: and the JAX CLI's compile cache.
SKIP = {"metrics.json", "telemetry.jsonl", "trace.json", "xla_cache"}


def box(name: str) -> str:
    return os.path.join(ROOT, "sboxes", f"{name}.txt")


DES = [box(f"des_s{i}") for i in range(1, 9)]
G99_STATE = os.path.join(ROOT, "tests", "data", "torch_golden",
                         "rijndael_g99_state.xml")
G99_BOX = os.path.join(ROOT, "tests", "data", "torch_golden",
                       "rijndael_planted_bit0.txt")
DEV = {"SBG_DISABLE_NATIVE": "1"}

#: case -> (argv without --output-dir, environment, mux on, crash spec).
#: A crash spec makes the golden the directory the JAX CLI leaves when that
#: fault kills it (exit 17), for the port to resume.
CASES = {
    # C2: the mux as the JAX package runs it on an accelerator.
    "mux_crypto1_fa": (["-o", "0", "--seed", "1", box("crypto1_fa")],
                       DEV, True, None),
    "mux_des_s1_dev": (["-l", "-o", "0", "--seed", "1", box("des_s1")],
                       DEV, True, None),
    "serial_mux_crypto1_fa": (["--serial-mux", "-o", "0", "--seed", "1",
                               box("crypto1_fa")], DEV, True, None),
    # batched restarts
    "bi_crypto1_fa_o0": (["-i", "3", "--batch-iterations", "-o", "0",
                          "--seed", "2", box("crypto1_fa")], {}, False, None),
    "bi_crypto1_fc_all": (["-i", "2", "--batch-iterations", "--seed", "3",
                           box("crypto1_fc")], {}, False, None),
    "bi_des_s1_lut_o0": (["-l", "-i", "3", "--batch-iterations", "-o", "0",
                          "--seed", "1", box("des_s1")], {}, False, None),
    # several S-boxes, permutation sweeps
    "mb_des12_lut_o0": (["-l", "-o", "0", "--seed", "1", box("des_s1"),
                         box("des_s2")], {}, False, None),
    "mb_des12_lut_o0_serial": (["-l", "-o", "0", "--seed", "1",
                                "--serial-jobs", box("des_s1"),
                                box("des_s2")], {}, False, None),
    "mb_crypto_all": (["--seed", "4", "-i", "2", box("crypto1_fa"),
                       box("crypto1_fb")], {}, False, None),
    "ps_crypto1_fa_o0": (["--permute-sweep", "-o", "0", "--seed", "5",
                          box("crypto1_fa")], {}, False, None),
    "ps_crypto1_fb_all_batched": (["--permute-sweep", "--seed", "6",
                                   box("crypto1_fb")], {}, False, None),
    "mb_crypto_all_killed": (["--seed", "4", "-i", "2", "--serial-jobs",
                              box("crypto1_fa"), box("crypto1_fb")], {}, False,
                             "ckpt.write:crash@3"),
    "mb_crypto_all_serial": (["--seed", "4", "-i", "2", "--serial-jobs",
                              box("crypto1_fa"), box("crypto1_fb")], {}, False,
                             None),
    # the fleet
    "fleet_crypto_dev_o0": (["--fleet", "-o", "0", "--seed", "7",
                             box("crypto1_fa"), box("crypto1_fb"),
                             box("crypto1_fc")], DEV, False, None),
    "fleet_des8_lut_o0": (["--fleet", "-l", "-o", "0", "--seed", "1", *DES],
                          {}, False, None),
    "fleet_ps_crypto1_fa_wave4": (["--fleet", "--permute-sweep",
                                   "--fleet-max-wave", "4", "-o", "0",
                                   "--seed", "8", box("crypto1_fa")], {},
                                  False, None),
    "fleet_bi_crypto1_fc": (["--fleet", "-i", "4", "--seed", "9",
                             box("crypto1_fc")], DEV, False, None),
    "fleet_des12_all": (["--fleet", "--seed", "3", box("des_s1"),
                         box("des_s2")], {}, False, None),
    "fleet_des12_all_killed": (["--fleet", "--seed", "3", box("des_s1"),
                                box("des_s2")], {}, False,
                               "search.round:crash@2"),
    # SBG_ENGINE_MUX_THREADS > 1: the native LUT engine's threaded mux.
    "emt4_des_s1_lut_o0": (["-l", "-o", "0", "--seed", "1", box("des_s1")],
                           {"SBG_ENGINE_MUX_THREADS": "4"}, False, None),
    # chip_smoke.py phase 11 on the card (mux on wherever it matters).
    "fleet_des8_dev_lut_o0": (["--fleet", "-l", "-o", "0", "--seed", "1",
                               *DES], DEV, False, None),
    "serial_des8_dev_lut_o0": (["--serial-jobs", "-l", "-o", "0", "--seed",
                                "1", *DES], DEV, True, None),
    "mb_des8_lut_o0": (["-l", "-o", "0", "--seed", "1", *DES], {}, False,
                       None),
    "fleet_ps_des_s1_dev": (["--fleet", "--permute-sweep", "-l", "-o", "0",
                             "--seed", "1", box("des_s1")], DEV, False, None),
    "fleet_g99_i8_dev": (["--fleet", "-l", "-o", "0", "-i", "8", "--seed",
                          "1", "-g", G99_STATE, G99_BOX], DEV, False, None),
    "emt4_g99_mux": (["-l", "-o", "0", "--seed", "1", "-g", G99_STATE,
                      G99_BOX], {"SBG_ENGINE_MUX_THREADS": "4"}, True, None),
    "serial_mux_des_s1_dev": (["--serial-mux", "-l", "-o", "0", "--seed", "1",
                               box("des_s1")], DEV, True, None),
    "mux_g99_dev": (["-l", "-o", "0", "--seed", "1", "-g", G99_STATE, G99_BOX],
                    DEV, True, None),
    "mux_g99_native": (["-l", "-o", "0", "--seed", "1", "-g", G99_STATE,
                        G99_BOX], {}, True, None),
}


def golden_case(case):
    argv, env, _, _ = CASES[case]
    return argv, env


def golden_dir(case):
    return os.path.join(GOLDEN, case)


def run_files(d):
    """{relative path: bytes} of a run directory's search files."""
    out = {}
    for base, dirs, files in os.walk(d):
        dirs[:] = [x for x in dirs if x not in SKIP]
        for f in files:
            if f in SKIP or f.startswith("flight-") or f.endswith(".tmp"):
                continue
            p = os.path.join(base, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, d)] = fh.read()
    return out


def marked(data: bytes, rel: str) -> bytes:
    """A file's bytes with the checkout root written as the mark (journals
    only; the XML files hold no path)."""
    if "journal" in rel:
        return data.replace(ROOT.encode(), ROOT_MARK.encode())
    return data


def compare_run(case, d):
    """The run directory ``d`` holds exactly the golden's files, byte for
    byte (journals compared with the root marked)."""
    want = run_files(golden_dir(case))
    got = {rel: marked(b, rel) for rel, b in run_files(d).items()}
    assert sorted(got) == sorted(want), (case, sorted(got), sorted(want))
    for rel in want:
        assert got[rel] == want[rel], (case, rel)


def copy_golden(case, d):
    """The golden run directory of ``case`` copied to ``d``, the root
    written back into its journals (a killed run to resume)."""
    src = golden_dir(case)
    for rel, data in run_files(src).items():
        p = os.path.join(d, rel)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        if "journal" in rel:
            data = data.replace(ROOT_MARK.encode(), ROOT.encode())
        with open(p, "wb") as fh:
            fh.write(data)


@contextlib.contextmanager
def environ(env):
    """``os.environ`` with ``env`` set and the job-axis switches it does not
    name unset, for the duration."""
    keys = ("SBG_DISABLE_NATIVE", "SBG_ENGINE_MUX_THREADS", "SBG_FAULTS")
    saved = {k: os.environ.get(k) for k in set(keys) | set(env)}
    for k in keys:
        os.environ.pop(k, None)
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def mux_on():
    """The port's contexts with ``parallel_mux`` None resolved on, as on a
    card, while on the CPU."""
    from sboxgates_tpu_torch.search import context

    init = context.SearchContext.__init__

    def patched(self, opt, *a, **k):
        if opt.parallel_mux is None:
            opt.parallel_mux = True
        init(self, opt, *a, **k)

    context.SearchContext.__init__ = patched
    try:
        yield
    finally:
        context.SearchContext.__init__ = init


def run_port_cli(argv, env, outdir, parallel_mux=False, extra=()):
    """The port's CLI in this process on the CPU: ``argv`` plus
    ``--output-dir outdir``; returns its exit code."""
    from sboxgates_tpu_torch import cli

    shutil.rmtree(outdir, ignore_errors=True)
    with environ(env), (mux_on() if parallel_mux else contextlib.nullcontext()):
        rc = cli.main([*argv, *extra, "--device", "cpu", "--output-dir",
                       outdir])
    assert rc == 0, rc
    return rc
