"""Goldens of the chained-round and serve CLI runs, written by the JAX CLI.

Each case of ``CASES`` is one command (or, for a store case, a sequence of
commands sharing one result store), run with the JAX package's CLI on the
CPU in a fresh process per command (that package picks its native route
once per process), from a scratch directory with relative ``--output-dir``
and ``--result-store`` paths.  The run directory's XML files and journals
(per-job subdirectories of a serve run included) and, for a store case,
the store's entries are copied to ``tests/data/torch_golden/<group>/<case>/``
with the checkout root written ``@ROOT@`` in the journals.  The port's
tests run the same commands (``run_port``) and hold their directories
against these (``compare_dir``).

The planted-chain S-boxes the cases search are written here too
(``planted_chain_sbox``): each output bit is built from the inputs and the
earlier outputs as an existing signal, a complement, a 3-LUT, a 5-LUT
decomposition or (one bit) a 7-leaf LUT tree, so a chain over them meets
every kind of round, one host fallback included, in seconds.  From the
root of a checkout:

    python tests/torch_round_goldens.py [case ...]

which needs the JAX package's requirements (on the CPU: the DES S1 chains
about 10 and 18 minutes, the device-route DES-8 serve a few minutes, the
rest seconds each).
"""

import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data", "torch_golden")
ROUNDS = os.path.join(DATA, "rounds")
SERVE = os.path.join(DATA, "serve")
ROOT_MARK = "@ROOT@"
DEV = {"SBG_DISABLE_NATIVE": "1"}

#: Names a run directory holds besides the search's own files.
SKIP = {"metrics.json", "telemetry.jsonl", "trace.json", "xla_cache",
        "index.jsonl", "waves.jsonl"}


def _box(name):
    return os.path.join(ROOT, "sboxes", f"{name}.txt")


def planted_path(i=None):
    return os.path.join(ROUNDS, "planted_chain.txt" if i is None
                        else f"planted_chain_{i}.txt")


DES = [_box(f"des_s{i}") for i in range(1, 9)]
PLANTED8 = [planted_path(i) for i in range(8)]


def planted_chain_sbox(seed=None):
    """The 8-bit S-box of a planted chain.  ``seed`` None: the fixed chain
    (bit 0 a 3-LUT of inputs, 1 a 5-LUT, 2 the complement of bit 0, 3 an
    input, 4 a 3-LUT over bits 0 and 1, 5 a 7-leaf LUT tree, 6 and 7
    3-LUT and 5-LUT forms over earlier signals); else each bit picks its
    form and operands from a generator with that seed."""
    from sboxgates_tpu_torch.core import ttable as tt

    inp = [tt.input_table(i) for i in range(8)]
    lut = tt.eval_lut
    if seed is None:
        o0 = lut(0x96, inp[0], inp[1], inp[2])
        o1 = lut(0xB4, lut(0x2D, inp[3], inp[4], inp[5]), inp[6], inp[7])
        o4 = lut(0xE8, o0, o1, inp[7])
        o6 = lut(0x6A, inp[1], inp[3], inp[5])
        outs = [
            o0, o1, ~o0, inp[5], o4,
            lut(0xCA, lut(0x96, inp[0], inp[3], inp[6]),
                lut(0xE8, inp[1], inp[4], inp[7]), inp[2]),
            o6, lut(0x1E, lut(0x72, o4, inp[2], inp[6]), o6, inp[0]),
        ]
    else:
        rng = np.random.default_rng(seed)
        sig = list(inp)
        outs = []
        deep = int(rng.integers(2, 8))
        for bit in range(8):
            pick = lambda k: [sig[int(x)] for x in  # noqa: E731
                              rng.choice(len(sig), k, replace=False)]
            if bit == deep:
                a = pick(7)
                o = lut(0xCA, lut(0x96, *a[:3]), lut(0xE8, *a[3:6]), a[6])
            else:
                form = int(rng.integers(5))
                if form == 0 and outs:
                    o = ~outs[int(rng.integers(len(outs)))]
                elif form == 1:
                    o = pick(1)[0]
                elif form == 2:
                    o = lut(int(rng.integers(1, 255)), *pick(3))
                else:
                    a = pick(5)
                    o = lut(int(rng.integers(1, 255)),
                            lut(int(rng.integers(1, 255)), *a[:3]), a[3], a[4])
            outs.append(o)
            sig.append(o)
    bits = [tt.to_bits(o).astype(np.int64) for o in outs]
    return sum(b << i for i, b in enumerate(bits))


def write_planted_boxes():
    os.makedirs(ROUNDS, exist_ok=True)
    for i, path in [(None, planted_path())] + list(enumerate(PLANTED8)):
        s = planted_chain_sbox(None if i is None else 40 + i)
        with open(path, "w") as f:
            f.write("\n".join(" ".join("%02x" % v for v in s[r * 16:(r + 1) * 16])
                              for r in range(16)) + "\n")


#: case -> (group, [(argv, environment, crash spec)], store): the commands
#: of one case run in order in one scratch directory (``--output-dir`` and
#: ``--result-store`` relative to it); the golden is the LAST command's
#: output directory (and the store's entries with ``store``).  A crash spec
#: runs that command under ``SBG_FAULTS`` and expects exit 17.
CASES = {
    # --chain-rounds on the planted chain, both routes, N = 1 and 4.
    "planted_n4": ("rounds", [(["-l", "--chain-rounds", "4", "--seed", "1",
                                planted_path()], {}, None)], False),
    "planted_n1": ("rounds", [(["-l", "--chain-rounds", "1", "--seed", "1",
                                planted_path()], {}, None)], False),
    "planted_n4_dev": ("rounds", [(["-l", "--chain-rounds", "4",
                                    "--serial-mux", "--seed", "1",
                                    planted_path()], DEV, None)], False),
    "planted_n1_dev": ("rounds", [(["-l", "--chain-rounds", "1",
                                    "--serial-mux", "--seed", "1",
                                    planted_path()], DEV, None)], False),
    # DES S1 as one chain (every round a host fallback), for the card
    # (chip_smoke phase 12a): the mux pinned serial, as a card would run it
    # concurrently.  About 10 minutes of the JAX CLI on the CPU each.
    "des_s1_n8": ("rounds", [(["-l", "--chain-rounds", "8", "--serial-mux",
                               "--seed", "1", DES[0]], {}, None)], False),
    "des_s1_n8_dev": ("rounds", [(["-l", "--chain-rounds", "8",
                                   "--serial-mux", "--seed", "1", DES[0]],
                                  DEV, None)], False),
    # Killed after its third chain_round record (run_start, chain_seeds,
    # then rounds 0-2): the directory the port resumes.
    "planted_n4_killed": ("rounds", [(["-l", "--chain-rounds", "4", "--seed",
                                       "1", planted_path()], {},
                                      "journal.append:crash@5")], False),
    # The serve: chained jobs in merged waves and not, and the re-serve of
    # a result store (every job a hit).
    "serve_chain8": ("serve", [(["-l", "--serve", "--serve-lanes", "4",
                                 "--chain-rounds", "4", "--seed", "1",
                                 *PLANTED8], {}, None)], False),
    "serve_chain8_nomerge": ("serve", [(["-l", "--serve", "--serve-lanes",
                                         "4", "--chain-rounds", "4",
                                         "--seed", "1", "--serve-no-merge",
                                         *PLANTED8], {}, None)], False),
    "serve_chain8_dev": ("serve", [(["-l", "--serve", "--serve-lanes", "4",
                                     "--chain-rounds", "4", "--serial-mux",
                                     "--seed", "1", *PLANTED8], DEV, None)],
                         False),
    "serve_chain8_store": ("serve", [
        (["-l", "--serve", "--serve-lanes", "4", "--chain-rounds", "4",
          "--seed", "1", "--result-store", "S", *PLANTED8], {}, None),
        (["-l", "--serve", "--serve-lanes", "4", "--chain-rounds", "4",
          "--seed", "1", "--result-store", "S", *PLANTED8], {}, None),
    ], True),
    # The DES-8 serve, one output per job, on the device route (the card's
    # phase: K3's lane form under merged waves) and the default route.
    "serve_des8_o0_dev": ("serve", [(["-l", "-o", "0", "--serve",
                                      "--serve-lanes", "4", "--serial-mux",
                                      "--seed", "1", *DES], DEV, None)],
                          False),
    "serve_des8_o0": ("serve", [(["-l", "-o", "0", "--serve",
                                  "--serve-lanes", "4", "--seed", "1",
                                  *DES], {}, None)], False),
}


def golden_dir(case):
    group = CASES[case][0]
    return os.path.join(ROUNDS if group == "rounds" else SERVE, case)


def _out_args(i, n):
    """The output directory of command ``i`` of ``n``: D (the last), or
    D<i> for the earlier ones."""
    return ["--output-dir", "D" if i == n - 1 else f"D{i}"]


def files_of(d, store=None):
    """{relative path: bytes} of a run directory's search files (and, with
    ``store``, of the store's entries under ``store/``), the checkout root
    written as the mark in the journals."""
    out = {}
    roots = [(d, "")] + ([(store, "store")] if store else [])
    for top, prefix in roots:
        for base, dirs, files in os.walk(top):
            dirs[:] = sorted(x for x in dirs
                             if x not in SKIP and x != "quarantine")
            for f in files:
                if f in SKIP or f.startswith("flight-") or ".sbg-tmp-" in f:
                    continue
                p = os.path.join(base, f)
                rel = os.path.join(prefix, os.path.relpath(p, top))
                with open(p, "rb") as fh:
                    data = fh.read()
                if "journal" in f:
                    data = data.replace(ROOT.encode(), ROOT_MARK.encode())
                out[rel] = data
    return out


def compare_dir(golden, d, store=None):
    """``d`` (and ``store``) hold exactly the golden's files, byte for
    byte.  Of the store, every entry's name and the bytes of the entries
    one job alone publishes (``m`` keys: a job's own S-box; ``f-``
    frontiers): a canonical single-output key several jobs publish keeps
    whichever job's circuit landed first, which depends on the order the
    jobs finish."""
    want = {}
    for base, _, files in os.walk(golden):
        for f in files:
            p = os.path.join(base, f)
            with open(p, "rb") as fh:
                want[os.path.relpath(p, golden)] = fh.read()
    got = files_of(d, store)
    assert sorted(got) == sorted(want), (golden, sorted(got), sorted(want))
    for rel in want:
        name = os.path.basename(rel)
        if rel.startswith("store") and not name.startswith(("m", "f-")):
            continue
        assert got[rel] == want[rel], (golden, rel)


def paste_golden(golden, d):
    """The golden's run files copied to ``d``, the root written back into
    its journals (a killed run to resume)."""
    for base, _, files in os.walk(golden):
        for f in files:
            src = os.path.join(base, f)
            dst = os.path.join(d, os.path.relpath(src, golden))
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            with open(src, "rb") as fh:
                data = fh.read()
            if "journal" in f:
                data = data.replace(ROOT_MARK.encode(), ROOT.encode())
            with open(dst, "wb") as fh:
                fh.write(data)


def run_port(argv, env, d, extra=(), expect=0):
    """The port's CLI in this process on the CPU: ``argv`` plus
    ``--output-dir d``; returns its exit code."""
    from sboxgates_tpu_torch import cli
    from torch_cli_helpers import environ

    shutil.rmtree(d, ignore_errors=True)
    with environ(env):
        rc = cli.main([*argv, *extra, "--device", "cpu", "--output-dir", d])
    assert rc == expect, rc
    return rc


def jax_cli(argv, env_extra, cwd) -> int:
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu", SBG_WARMUP="0")
    for k in ("SBG_DISABLE_NATIVE", "SBG_FAULTS", "SBG_ENGINE_MUX_THREADS",
              "SBG_RESULT_STORE", "SBG_SERVE_NO_MERGE"):
        env.pop(k, None)
    env.update(env_extra)
    return subprocess.run([sys.executable, "-m", "sboxgates_tpu", *argv],
                          env=env, cwd=cwd).returncode


def write_golden(case, scratch) -> None:
    _, cmds, store = CASES[case]
    cwd = os.path.join(scratch, case)
    os.makedirs(cwd)
    for i, (argv, env, crash) in enumerate(cmds):
        env = dict(env)
        if crash:
            env["SBG_FAULTS"] = crash
        rc = jax_cli([*argv, *_out_args(i, len(cmds))], env, cwd)
        if rc != (17 if crash else 0):
            raise SystemExit(f"{case}: the JAX CLI exited {rc}")
    out = golden_dir(case)
    shutil.rmtree(out, ignore_errors=True)
    files = files_of(os.path.join(cwd, "D"),
                     os.path.join(cwd, "S") if store else None)
    for rel, data in files.items():
        p = os.path.join(out, rel)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "wb") as f:
            f.write(data)
    print(f"{case}: {len(files)} files", flush=True)


def main(argv) -> int:
    write_planted_boxes()
    cases = argv or sorted(CASES)
    scratch = tempfile.mkdtemp(prefix="sbg-round-goldens-")
    try:
        for case in cases:
            write_golden(case, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main(sys.argv[1:]))
