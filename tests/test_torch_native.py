"""The port's native host runtime (sboxgates_tpu_torch.native) and its
placement.

- The native node heads (gate-mode ``gate_step``, the LUT head
  ``lut_step``, the single-chunk 7-LUT step's stage A and small solve)
  give the verdicts of the port's device route and of the JAX package's
  jitted kernels on the same random states, with the same sweep counters
  (exact equality; on a gate-step miss only the step is specified).
- ``execute_native`` evaluates every ``examples/*.xml`` to its stored
  tables and to the plain evaluator's outputs.
- A failure of the LUT engine's device-work service makes the engine bail
  and the node rerun on the Python engine, with one stderr line.
- The loader builds ``csrc/runtime.cpp`` into ``build/torch_native/`` and
  opens no file of the JAX package.
"""

import ctypes
import glob
import os
import subprocess

import numpy as np
import pytest
import torch

from sboxgates_tpu.core import boolfunc as jbf
from sboxgates_tpu.core import ttable as jtt
from sboxgates_tpu.graph.state import GATES
from sboxgates_tpu.graph.state import State as JState
from sboxgates_tpu.search import context as jctx

from sboxgates_tpu_torch import native
from sboxgates_tpu_torch.codegen import compile_circuit
from sboxgates_tpu_torch.codegen.executor import execute_native
from sboxgates_tpu_torch.core import ttable as tt
from sboxgates_tpu_torch.graph.state import NO_GATE, State
from sboxgates_tpu_torch.graph.xmlio import load_state
from sboxgates_tpu_torch.ops.sweeps import as_words, to_u32
from sboxgates_tpu_torch.search import context as tctx
from sboxgates_tpu_torch.search import kwan
from sboxgates_tpu_torch.search import lut as tlut

# The suite runs several worker processes on shared cores; torch's
# intra-op thread pool in each of them oversubscribes the host.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(glob.glob(os.path.join(ROOT, "examples", "*.xml")))
STAT_KEYS = ("pair_candidates", "triple_candidates", "lut3_candidates",
             "lut5_candidates", "lut7_candidates", "lut7_solved")


def _port_state(jst):
    """The JAX package's state as the port's (same gates and tables)."""
    gates = [(g.type, g.in1, g.in2, g.in3, g.function) for g in jst.gates]
    return State.from_numpy(gates, jst.live_tables(), jst.outputs,
                            max_gates=jst.max_gates,
                            max_sat_metric=jst.max_sat_metric,
                            sat_metric=jst.sat_metric)


def _rand_gate_state(rng, num_inputs, extra):
    """tests/test_native.py's random gate state."""
    st = JState.init_inputs(num_inputs)
    while st.num_gates < num_inputs + extra:
        a, b = rng.choice(st.num_gates, size=2, replace=False)
        if rng.integers(0, 4) == 0:
            st.add_not_gate(int(a), GATES)
        else:
            st.add_gate(
                int(rng.choice([jbf.AND, jbf.OR, jbf.XOR])), int(a), int(b), GATES
            )
    return st


def _contexts(seed, **kw):
    """(port native, port device, JAX device) contexts, same options."""
    return (
        tctx.SearchContext(tctx.Options(seed=seed, device="cpu",
                                        native=True, **kw)),
        tctx.SearchContext(tctx.Options(seed=seed, device="cpu",
                                        native=False, **kw)),
        jctx.SearchContext(jctx.Options(seed=seed, host_small_steps=False, **kw)),
    )


def _stats(ctx):
    return {k: int(ctx.stats[k]) if k in ctx.stats else 0 for k in STAT_KEYS}


def _gate_cases():
    """test_native.py's case mix (random, existing-gate, pair and
    partial-mask targets over random states) and triple targets, plus a
    pair target over a 70-gate state (the 512-row pair bucket)."""
    rng = np.random.default_rng(99)
    out = []
    for case in range(26):
        num_inputs = int(rng.integers(3, 7))
        extra = int(rng.integers(3, 9)) if case < 25 else 64
        st = _rand_gate_state(rng, num_inputs, extra)
        mask = np.asarray(jtt.mask_table(num_inputs))
        kind = case % 5 if case < 25 else 2
        if kind == 0:
            target = rng.integers(0, 2**32, size=8, dtype=np.uint32) & mask
        elif kind == 1:
            gid = int(rng.integers(0, st.num_gates))
            target = st.table(gid) if rng.integers(0, 2) else ~st.table(gid)
            target = np.asarray(target) & mask
        elif kind == 2:
            a, b = rng.choice(st.num_gates, size=2, replace=False)
            target = np.asarray(
                jtt.eval_gate2(jbf.NAND, st.table(int(a)), st.table(int(b)))
            ) & mask
        elif kind == 3:
            sel = st.table(int(rng.integers(0, num_inputs)))
            mask = mask & ~np.asarray(sel)
            target = rng.integers(0, 2**32, size=8, dtype=np.uint32) & mask
        else:
            a, b, c = (st.table(int(x)) for x in
                       rng.choice(st.num_gates, size=3, replace=False))
            target = np.asarray(((a & ~b) | c) ^ (b & c)) & mask
        out.append((st, target, mask))
    return out


GATE_CASES = _gate_cases()


def test_native_library_builds():
    assert native.available(), native.build_error()


@pytest.mark.parametrize("randomize", [False, True])
@pytest.mark.parametrize("try_nots", [False, True])
def test_gate_step_native_matches_device_and_jax(randomize, try_nots):
    """One context of each kind walks every case: each draws one seed per
    node head, so their seed streams and counters stay in step.  A hit
    decodes (decode_pair_hit, decode_triple_hit) to the JAX package's
    gates and match entry."""
    steps = set()
    cn, cd, cj = _contexts(4242 if randomize else None,
                           randomize=randomize, try_nots=try_nots)
    for i, (jst, target, mask) in enumerate(GATE_CASES):
        st = _port_state(jst)
        assert cn.uses_native_step(st) and not cd.uses_native_step(st)
        got_n = cn.gate_step(st, target, mask)
        got_d = cd.gate_step(st, target, mask)
        want = cj.gate_step(jst, target, mask)
        if want[0] == 0:
            assert got_n[0] == got_d[0] == 0, i
        else:
            assert got_n == got_d == want, i
        if want[0] in (3, 4):
            g1, g2, e = cd.decode_pair_hit(st, want[1], want[2], want[0] == 4)
            jg1, jg2, je = cj.decode_pair_hit(jst, want[1], want[2], want[0] == 4)
            assert (g1, g2, e.fun.fun, e.perm) == (jg1, jg2, je.fun.fun, je.perm), i
        elif want[0] == 5:
            gids, e = cd.decode_triple_hit(st, want[1], want[2])
            jgids, je = cj.decode_triple_hit(jst, want[1], want[2])
            assert (gids, e.fun.fun, e.perm) == (list(jgids), je.fun.fun, je.perm), i
        assert _stats(cn) == _stats(cd) == _stats(cj), i
        steps.add(got_n[0])
    assert {0, 1, 2, 3, 5} <= steps, steps
    if try_nots:
        assert 4 in steps


def test_one_shot_gate_step_matches_the_context():
    """native.gate_step (the one-shot form, uint64 tables) returns the
    verdict the context's cached caller does."""
    jst, target, mask = GATE_CASES[4]
    st = _port_state(jst)
    ctx = tctx.SearchContext(tctx.Options(seed=3, device="cpu", try_nots=True))
    g = st.num_gates
    total3 = tctx.comb.n_choose_k(g, 3)
    chunk3 = tctx.pick_chunk(max(total3, 1), tctx.STREAM_CHUNK[3])
    v = native.gate_step(
        native.tables32_to_64(st.live_tables()), g, tctx.bucket_size(g),
        native.tables32_to_64(target), native.tables32_to_64(mask),
        ctx.pair_table_np, ctx.not_table_np, ctx.triple_table_np, total3, chunk3,
        12345,
    )
    ctx.next_seed = lambda: 12345
    assert tuple(int(x) for x in v[:3]) == ctx.gate_step(st, target, mask)


def _lut_cases():
    """LUT-head states: 8-input AND/OR/XOR/A_AND_NOT_B states with targets
    that stop the head at each step (existing, complement, pair, 3-LUT,
    small-space 5-LUT), a miss, and a 5-LUT space with an exclusion."""
    from sboxgates_tpu.graph.state import State as S

    rng = np.random.default_rng(8)
    out = []
    for g in (20, 24):
        st = S.init_inputs(8)
        funs = (jbf.AND, jbf.OR, jbf.XOR, jbf.A_AND_NOT_B)
        while st.num_gates < g:
            a, b = rng.choice(st.num_gates, size=2, replace=False)
            st.add_gate(funs[int(rng.integers(len(funs)))], int(a), int(b), GATES)
        t = st.live_tables()
        mask = np.asarray(jtt.mask_table(8))
        out += [
            (st, t[13].copy(), mask, []),
            (st, ~t[17], mask, []),
            (st, t[4] ^ t[15], mask, []),
            (st, jtt.eval_lut(0x6B, t[2], t[9], t[18]), mask, []),
            (st, jtt.eval_lut(0xB4, jtt.eval_lut(0x2D, t[0], t[3], t[5]), t[6], t[7]),
             mask, [1]),
            (st, rng.integers(0, 2**32, size=8, dtype=np.uint32), mask, [2, 5]),
        ]
    return out


LUT_CASES = _lut_cases()


@pytest.mark.parametrize("randomize", [False, True])
def test_lut_step_native_matches_device_and_jax(randomize):
    steps = set()
    for i, (jst, target, mask, inbits) in enumerate(LUT_CASES):
        seed = 1000 + i if randomize else None
        cn, cd, cj = _contexts(seed, randomize=randomize, lut_graph=True)
        st = _port_state(jst)
        got_n = cn.lut_step(st, target, mask, inbits)
        got_d = cd.lut_step(st, target, mask, inbits)
        want = np.asarray(cj.lut_step(jst, target, mask, inbits))
        np.testing.assert_array_equal(got_n, want)
        np.testing.assert_array_equal(got_d, want)
        assert _stats(cn) == _stats(cd) == _stats(cj), i
        steps.add(int(got_n[0]))
    assert {0, 1, 2, 3, 4, 5} <= steps, steps


def _lut7_cases():
    """18-gate states (C(18,7) fits the single-chunk 7-LUT step): 7-LUTs
    planted over the first seven inputs (the first feasible rank) and over
    derived gates under a partial mask, and a random target."""
    from sboxgates_tpu.graph.state import State as S

    rng = np.random.default_rng(3)
    st = S.init_inputs(8)
    funs = [jbf.AND, jbf.OR, jbf.XOR, jbf.A_AND_NOT_B]
    while st.num_gates < 18:
        a, b = rng.choice(st.num_gates, size=2, replace=False)
        st.add_gate(funs[rng.integers(len(funs))], int(a), int(b), GATES)
    t = st.live_tables()
    outer = jtt.eval_lut(0x96, t[8], t[11], t[17])
    middle = jtt.eval_lut(0xE8, t[9], t[14], t[16])
    planted = jtt.eval_lut(0xCA, outer, middle, t[13])
    on_inputs = jtt.eval_lut(
        0xCA, jtt.eval_lut(0x96, t[0], t[3], t[5]),
        jtt.eval_lut(0xE8, t[1], t[2], t[4]), t[6],
    )
    mask = np.asarray(jtt.mask_table(8))
    half = mask & ~t[7]
    return [
        (st, on_inputs, mask, []),
        (st, planted & half, half, [7]),
        (st, rng.integers(0, 2**32, size=8, dtype=np.uint32), mask, []),
    ]


LUT7_CASES = _lut7_cases()


@pytest.mark.parametrize("randomize", [False, True])
def test_lut7_step_native_matches_device_and_jax(randomize):
    statuses = set()
    for i, (jst, target, mask, inbits) in enumerate(LUT7_CASES):
        assert jctx.lut_head_has7(jst.num_gates)
        seed = 77 + i if randomize else None
        cn, cd, cj = _contexts(seed, randomize=randomize, lut_graph=True)
        st = _port_state(jst)
        got_n = cn.lut7_step(st, target, mask, inbits)
        got_d = cd.lut7_step(st, target, mask, inbits)
        want = np.asarray(cj.lut7_step(jst, target, mask, inbits))
        np.testing.assert_array_equal(got_n, want)
        np.testing.assert_array_equal(got_d, want)
        assert _stats(cn) == _stats(cd) == _stats(cj), i
        statuses.add(int(got_n[0]))
    assert {0, 1} <= statuses, statuses


@pytest.mark.parametrize("path", EXAMPLES, ids=os.path.basename)
def test_execute_native_matches_the_plain_evaluator(path):
    st = load_state(path)
    got = execute_native(st)
    np.testing.assert_array_equal(got, st.live_tables())
    outs = [st.outputs[b] for b in range(8) if st.outputs[b] != NO_GATE]
    inputs = as_words(np.stack([tt.input_table(i) for i in range(st.num_inputs)]),
                      "cpu")
    plain = to_u32(compile_circuit(st)(inputs))
    np.testing.assert_array_equal(got[outs], plain)


def test_tables32_to_64_keeps_the_bytes():
    t = np.random.default_rng(1).integers(0, 2**32, size=(5, 8), dtype=np.uint32)
    t64 = native.tables32_to_64(t)
    assert t64.dtype == np.uint64 and t64.shape == (5, 4)
    assert t64.tobytes() == t.tobytes()
    np.testing.assert_array_equal(t64[:, 0], t[:, 0].astype(np.uint64)
                                  | (t[:, 1].astype(np.uint64) << np.uint64(32)))


def _lut_engine_node():
    """A 20-gate LUT node whose 7-LUT space needs the staged search (kind
    3 of the engine's service) before any mux: a random target."""
    from sboxgates_tpu_torch.core import boolfunc as bf

    rng = np.random.default_rng(4)
    st = State.init_inputs(8)
    while st.num_gates < 20:
        a, b = rng.choice(st.num_gates, size=2, replace=False)
        st.add_gate(int(rng.choice([bf.AND, bf.OR, bf.XOR])), int(a), int(b), GATES)
    target = rng.integers(0, 2**32, size=8, dtype=np.uint32)
    return st, target, tt.mask_table(8)


def test_lut_engine_service_failure_falls_back_to_python_engine(monkeypatch,
                                                               capsys):
    """A failed device-work service makes the engine bail: the counters
    its call added are dropped, one stderr line reports it, and the node
    runs on the Python engine (whose own 7-LUT search here misses), as in
    the JAX package; the exception does not propagate."""
    calls = []

    def fails_once(ctx, st, target, mask, inbits):
        calls.append(st.num_gates)
        if len(calls) == 1:
            raise RuntimeError("device launch failed")
        return None

    monkeypatch.setattr(tlut, "lut7_search", fails_once)
    ctx = tctx.SearchContext(tctx.Options(seed=1, device="cpu", lut_graph=True))
    st, target, mask = _lut_engine_node()
    st.max_gates = 24
    assert ctx.uses_native_engine(st)
    failures = native.service_failure_count()
    capsys.readouterr()
    out = kwan.create_circuit(ctx, st, target, mask, [])
    err = capsys.readouterr().err.strip().splitlines()
    assert native.service_failure_count() == failures + 1
    assert len(err) == 1 and "fell back to the Python engine" in err[0]
    assert "device launch failed" in err[0]
    assert calls[:2] == [20, 20]  # the engine's request, then the Python node
    assert ctx.stats["python_nodes"] >= 1
    if out != NO_GATE:
        st.verify_gate(out, target, mask)


def test_broken_engine_service_reruns_the_node_as_the_jax_package_does(
        monkeypatch, capsys):
    """The engine's device service broken the same way in both packages
    (as tests/test_native.py's ``broken_service``), on the JAX tests' planted
    50-gate node (the pivot sweep, K1's plain version here) and one seed:
    the same gate comes back, the same gates are added, the restored
    counters and the PRNG position after the Python engine's rerun agree,
    and each package prints its one stderr line."""
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from planted import build_planted_lut5

    from sboxgates_tpu import native as jnative
    from sboxgates_tpu.search.kwan import create_circuit as jcreate_circuit

    # Each package prints its first few failures: start both counts at 0.
    monkeypatch.setattr(jnative, "_SERVICE_FAILURES", 0)
    monkeypatch.setattr(native, "_SERVICE_FAILURES", 0)

    def broken_service(ctx):
        # Counts part of a sweep, then fails: the bail drops that count.
        def service(*args):
            ctx.stats.inc("lut5_candidates", 1000)
            raise RuntimeError("simulated device failure")
        return service

    jst, target, mask = build_planted_lut5()
    st = _port_state(jst)
    j = jctx.SearchContext(jctx.Options(seed=2, lut_graph=True))
    j._lut_engine_service_fn = (j, broken_service(j))
    t = tctx.SearchContext(tctx.Options(seed=2, device="cpu", lut_graph=True,
                                        native=True))
    assert t.uses_native_engine(st)
    t.lut_engine_devcb = native.make_eng_devcb(broken_service(t))
    capsys.readouterr()
    want = jcreate_circuit(j, jst, target, mask, [])
    jerr = capsys.readouterr().err.strip().splitlines()
    got = kwan.create_circuit(t, st, target, mask, [])
    err = capsys.readouterr().err.strip().splitlines()
    assert got == want != NO_GATE
    st.verify_gate(got, target, mask)
    assert ([(g.type, g.in1, g.in2, g.in3, g.function) for g in st.gates]
            == [(g.type, g.in1, g.in2, g.in3, g.function) for g in jst.gates])
    keys = STAT_KEYS + ("lut5_solved", "python_nodes", "engine_nodes",
                        "engine_devcalls")
    assert ({k: int(t.stats.get(k, 0)) for k in keys}
            == {k: int(j.stats.get(k, 0)) for k in keys})
    assert t.stats["python_nodes"] >= 1 and t.stats["lut5_candidates"] > 0
    assert t.rng_snapshot() == j.rng_snapshot()
    assert len(err) == len(jerr) == 1
    assert err[0].replace("sboxgates_tpu_torch", "sboxgates_tpu") == jerr[0]


def test_lut_engine_services_device_work(monkeypatch):
    """A service that answers every staged 7-LUT request with a miss: the
    engine counts its requests and finishes on its own."""
    calls = []

    def miss(ctx, st, target, mask, inbits):
        calls.append(st.num_gates)
        assert isinstance(st, kwan._EngineView)
        return None

    monkeypatch.setattr(tlut, "lut7_search", miss)
    ctx = tctx.SearchContext(tctx.Options(seed=1, device="cpu", lut_graph=True))
    st, target, mask = _lut_engine_node()
    st.max_gates = 24
    kwan.create_circuit(ctx, st, target, mask, [])
    assert calls and ctx.stats["engine_devcalls"] == len(calls)
    assert ctx.stats["engine_nodes"] >= 1 and "python_nodes" not in ctx.stats


def test_loader_builds_only_the_repos_runtime(tmp_path, monkeypatch):
    """A fresh build compiles csrc/runtime.cpp into the build directory and
    loads that library; no path it compiles or opens is under the JAX
    package."""
    runs, loads = [], []
    real_run, real_cdll = subprocess.run, ctypes.CDLL

    def run(cmd, *a, **kw):
        runs.append(list(cmd))
        return real_run(cmd, *a, **kw)

    def cdll(path, *a, **kw):
        loads.append(path)
        return real_cdll(path, *a, **kw)

    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "torch_native"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    monkeypatch.setattr(native.subprocess, "run", run)
    monkeypatch.setattr(native.ctypes, "CDLL", cdll)
    assert native.available(), native.build_error()
    assert native.SRC_PATH == os.path.join(ROOT, "csrc", "runtime.cpp")
    assert len(runs) == 1 and runs[0][-1] == native.SRC_PATH
    assert loads == [str(tmp_path / "torch_native" / native.LIB_NAME)]
    jax_pkg = os.path.join(ROOT, "sboxgates_tpu") + os.sep
    for path in [*runs[0], *loads]:
        assert not str(path).startswith(jax_pkg), path
    # A second load reuses the built library (same digest), no compile.
    monkeypatch.setattr(native, "_lib", None)
    assert native.available() and len(runs) == 1


def test_unbuildable_runtime_falls_back_to_the_device(tmp_path, monkeypatch):
    """Without the library every node runs on the device route, with one
    warning (the JAX package's behaviour)."""
    monkeypatch.setattr(native, "SRC_PATH", str(tmp_path / "missing.cpp"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    ctx = tctx.SearchContext(tctx.Options(seed=1, device="cpu"))
    st = State.init_inputs(4)
    with pytest.warns(RuntimeWarning, match="native host runtime unavailable"):
        assert not ctx.uses_native_step(st)
    assert not ctx.uses_native_engine(st)
    assert "source not found" in native.build_error()


# A stand-in compiler: records its call, takes a second (so concurrent
# builds overlap) and writes the file named after -o.
_FAKE_COMPILER = """#!{python}
import sys, time
with open({log!r}, "a") as f:
    f.write("compile\\n")
time.sleep(1)
open(sys.argv[sys.argv.index("-o") + 1], "wb").close()
"""

# Builds with the module's BUILD_DIR set to argv[1]; prints the library path.
_BUILDER = """
import sys
from sboxgates_tpu_torch import {mod} as m
m.BUILD_DIR = sys.argv[1]
print(m.build())
"""


@pytest.mark.parametrize("mod,env_var,compiles", [
    ("native", "CXX", 1),
    # One nvcc per CUDA source, and the link.
    ("_kernels", "NVCC", len(glob.glob(os.path.join(
        ROOT, "sboxgates_tpu_torch", "csrc", "*.cu"))) + 1),
])
def test_concurrent_builds_compile_once(mod, env_var, compiles, tmp_path):
    """Two processes building into one empty build directory at once: the
    build lock makes one compile while the other waits, then finds the
    library current."""
    import sys

    log = tmp_path / "compiles.log"
    fake = tmp_path / "fake_compiler"
    fake.write_text(_FAKE_COMPILER.format(python=sys.executable, log=str(log)))
    fake.chmod(0o755)
    env = dict(os.environ, PYTHONPATH=ROOT, **{env_var: str(fake)})
    build_dir = str(tmp_path / "build")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILDER.format(mod=mod), build_dir],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    ) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert len({o[0].strip() for o in outs}) == 1
    assert log.read_text().count("compile") == compiles
