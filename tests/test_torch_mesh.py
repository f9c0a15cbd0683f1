"""The port's mesh (``sboxgates_tpu_torch.parallel``) against the JAX
package's on 8 shards.

The test process has the JAX package's 8 virtual CPU devices
(``conftest.py``); the port runs 8 CPU shards through ``SBG_LOCAL_SHARDS``.
The same seeded inputs go through the JAX functions on their 8-device mesh
and the port's on its 8-shard mesh: ``MeshPlan.shard_chunk``'s padding,
``lut5_fused_step``, the sharded pivot stream's verdict rows (both port
backends against the JAX ``xla`` and ``xla_bf16`` levers), the sharded
feasibility stream at k = 3, 5, 7, the capped 7-LUT stage A and the native
engine's continuation under a mesh.  Then the CLI with ``--mesh`` on both
routes against the JAX CLI's files at 8 devices (goldens of
``tests/torch_mesh_goldens.py``; the crypto1 case also live, in process).
Tolerance: exact equality (integer words and verdicts, file bytes).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sboxgates_tpu.ops import sweeps as jsw
from sboxgates_tpu.parallel import MeshPlan as JMeshPlan
from sboxgates_tpu.parallel import make_mesh as jmake_mesh
from sboxgates_tpu.parallel import mesh as jmesh
from sboxgates_tpu.search import context as jctx
from sboxgates_tpu.search.lut import PivotOperands as JPivotOperands

from sboxgates_tpu_torch.core import boolfunc as tbf
from sboxgates_tpu_torch.core import ttable as ttt
from sboxgates_tpu_torch.graph.state import GATES as TGATES
from sboxgates_tpu_torch.graph.state import State as TState
from sboxgates_tpu_torch.ops import combinatorics as tcomb
from sboxgates_tpu_torch.ops import sweeps as tsw
from sboxgates_tpu_torch.parallel import MeshPlan, make_mesh
from sboxgates_tpu_torch.parallel import mesh as tmesh
from sboxgates_tpu_torch.search import Options, SearchContext
from sboxgates_tpu_torch.search.lut import PivotOperands as TPivotOperands

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mesh_goldens as mg  # noqa: E402
from planted import build_planted_lut5  # noqa: E402
from torch_cli_helpers import environ  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")
SHARDS = 8


@pytest.fixture
def shards(monkeypatch):
    monkeypatch.setenv(tmesh.LOCAL_SHARDS_ENV, str(SHARDS))
    return SHARDS


def _plan():
    return MeshPlan(make_mesh(device="cpu"))


def _w(a):
    return tsw.as_words(a, CPU)


def test_local_shards_follow_the_variable(shards):
    plan = _plan()
    assert len(jax.devices()) == SHARDS
    assert plan.n_candidate_shards == SHARDS
    assert [i for i, _ in plan.shards()] == list(range(SHARDS))
    assert not plan.spans_processes


def test_shard_chunk_pads_to_multiple(shards):
    """The counterpart of the JAX package's test_sharding.py case."""
    arr = np.arange(10, dtype=np.uint32)
    out = _plan().shard_chunk(arr, fill=0xFFFFFFFF)
    jout = np.asarray(JMeshPlan(jmake_mesh()).shard_chunk(arr, fill=0xFFFFFFFF))
    assert out.shape[0] == 16
    assert np.array_equal(tsw.to_u32(out), jout)


def test_fused_step_sharded_equals_jax(shards):
    """``lut5_fused_step`` on 8 shards against the JAX function on its
    8-device mesh (the inputs of test_sharding.py's case)."""
    rng = np.random.default_rng(5)
    tables = ttt.from_bits(rng.integers(0, 2, size=(16, 256)).astype(bool))
    outer = ttt.eval_lut(0x5B, tables[1], tables[3], tables[5])
    target = ttt.eval_lut(0xC9, outer, tables[7], tables[9])
    mask = ttt.mask_table(8)
    combos = tcomb.CombinationStream(16, 5).next_chunk(4096)
    combos, nvalid = tcomb.pad_rows(combos, 4096)
    valid = np.arange(4096) < nvalid
    _, w_tab, m_tab = jsw.lut5_split_tables()
    jplan = JMeshPlan(jmake_mesh())
    want = jmesh.lut5_fused_step(
        jplan.replicate(tables), jplan.shard_chunk(combos),
        jplan.shard_chunk(valid), jplan.replicate(target),
        jplan.replicate(mask), jplan.replicate(w_tab),
        jplan.replicate(m_tab), 99,
    )
    plan = _plan()
    got = tmesh.lut5_fused_step(
        _w(tables), plan.shard_chunk(combos.astype(np.int32)),
        plan.shard_chunk(valid), _w(target), _w(mask), _w(w_tab),
        _w(m_tab), 99, plan=plan,
    )
    assert [int(x) for x in got] == [int(x) for x in want]
    assert int(got[0]) == 1


def test_restart_batched_filter_equals_jax():
    rng = np.random.default_rng(2)
    tables = ttt.from_bits(rng.integers(0, 2, size=(12, 256)).astype(bool))
    targets = ttt.from_bits(rng.integers(0, 2, size=(4, 256)).astype(bool))
    mask = ttt.mask_table(8)
    combos = tcomb.CombinationStream(12, 5).next_chunk(512)
    combos, nvalid = tcomb.pad_rows(combos, 512)
    valid = np.arange(512) < nvalid
    want = jmesh.restart_batched_filter()(
        jnp.asarray(tables), jnp.asarray(combos), jnp.asarray(valid),
        jnp.asarray(targets), jnp.asarray(mask))
    got = tmesh.restart_batched_filter()(
        _w(tables), torch.from_numpy(combos.astype(np.int32)),
        torch.from_numpy(valid), _w(targets), _w(mask))
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    for j in (1, 2):
        assert np.array_equal(tsw.to_u32(got[j]), np.asarray(want[j]))


# -- the sharded pivot stream ----------------------------------------------

TL, TH = 256, 512
_OPS = {}


def _pivot_ops(backend, tl=TL, th=TH):
    key = (backend, tl, th)
    if key not in _OPS:
        st, target, mask = build_planted_lut5()
        g = st.num_gates
        tabs = np.zeros((jctx.bucket_size(g), 8), np.uint32)
        tabs[:g] = st.live_tables()
        _OPS[key] = (
            JPivotOperands(g, tl, th, [], jnp.asarray(tabs), target, mask,
                           jnp.asarray),
            TPivotOperands(g, tl, th, [], _w(tabs), target, mask, CPU,
                           backend=backend),
        )
    return _OPS[key]


@pytest.mark.parametrize("lever,backend", [("xla", "packed"),
                                           ("xla_bf16", "pre")])
@pytest.mark.parametrize("start_t,seed", [(0, 7), (16, -1), (108, 3)])
def test_sharded_pivot_rows_equal_jax(lever, backend, start_t, seed, shards):
    """Verdict rows [8, 10] of the port's sharded pivot stream against the
    JAX function's on the planted G = 50 state (its hit in tile 18): a
    first round with a hit, a start past it, and the exhausted tail."""
    jops, tops = _pivot_ops(backend)
    _, w_tab, m_tab = jsw.lut5_split_tables()
    want = np.asarray(jmesh.sharded_pivot_stream(
        JMeshPlan(jmake_mesh()), *jops.stream_args(), start_t, jops.t_real,
        jnp.asarray(w_tab), jnp.asarray(m_tab), seed, tl=TL, th=TH,
        backend=lever,
    ))
    got = tmesh.sharded_pivot_stream(
        _plan(), *tops.stream_args(), start_t, tops.t_real, _w(w_tab),
        _w(m_tab), seed, tl=TL, th=TH, backend=backend,
    )
    assert got.shape == (SHARDS, 10)
    assert np.array_equal(got, want), (got, want)


def test_sharded_pivot_windows_do_not_change_rows(shards, monkeypatch):
    """Windows of one round and of many give the same rows (64 x 64
    tiles: many rounds, each cheap)."""
    _, tops = _pivot_ops("packed", 64, 64)
    _, w_tab, m_tab = jsw.lut5_split_tables()
    out = []
    for cap in (1, 3, 64):
        monkeypatch.setattr(tsw, "PIVOT_WINDOW_TILES", cap)
        out.append(tmesh.sharded_pivot_stream(
            _plan(), *tops.stream_args(), 0, tops.t_real, _w(w_tab),
            _w(m_tab), 5, tl=64, th=64))
    assert (out[0][:, 0] != 0).any()
    assert out[0][0, 9] > SHARDS  # a hit past the first round
    for rows in out[1:]:
        assert np.array_equal(rows, out[0])


# -- the sharded feasibility stream ------------------------------------------


def _stream_state(g, seed=3):
    rng = np.random.default_rng(seed)
    st = TState.init_inputs(8)
    funs = [tbf.AND, tbf.OR, tbf.XOR, tbf.A_AND_NOT_B]
    while st.num_gates < g:
        a, b = rng.choice(st.num_gates, size=2, replace=False)
        st.add_gate(funs[rng.integers(len(funs))], int(a), int(b), TGATES)
    return st


@pytest.mark.parametrize("k,g,chunk", [(3, 20, 512), (5, 16, 256),
                                       (7, 14, 128)])
def test_sharded_feasible_stream_equals_jax(k, g, chunk, shards):
    """The single-host sharded stream (verdict and every row of the hit
    chunk) against the JAX function's, with the exclusion list in play."""
    st = _stream_state(g)
    rng = np.random.default_rng(k)
    target = ttt.eval_lut(0x96, st.table(3), st.table(9), st.table(g - 1))
    if k > 3:
        target = ttt.eval_lut(0xCA, target, st.table(5), st.table(g - 2))
    mask = ttt.mask_table(8) & ttt.from_bits(
        rng.integers(0, 2, 256).astype(bool))
    total = tcomb.n_choose_k(g, k)
    excl = np.full(8, -1, np.int32)
    excl[0] = 2
    tabs = np.zeros((jctx.bucket_size(g), 8), np.uint32)
    tabs[:g] = st.live_tables()
    jplan = JMeshPlan(jmake_mesh())
    want = jmesh.sharded_feasible_stream(
        jplan, jplan.replicate(tabs), jplan.replicate(jsw.binom_table()), g,
        jplan.replicate(target), jplan.replicate(mask), jplan.replicate(excl),
        0, total, k=k, chunk=chunk)
    got = tmesh.sharded_feasible_stream(
        _plan(), _w(tabs), tsw.binom_device(CPU), g, _w(target), _w(mask),
        torch.from_numpy(excl), 0, total, k=k, chunk=chunk)
    assert [int(x) for x in got[0]] == [int(x) for x in np.asarray(want[0])]
    assert bool(got[0][0])
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    for j in (2, 3):
        assert np.array_equal(tsw.to_u32(got[j]),
                              np.asarray(want[j]).astype(np.uint32))


def test_capped_lut7_stage_a_under_mesh_equals_jax(shards):
    """The overflowed 7-LUT search's stage A on the mesh (the JAX package's
    capped case, test_sharding.py, at 22 gates): past the fused-head limit,
    the sharded k = 7 stream collects the same hit list, row for row, with
    the same candidate count, as the JAX package's on its mesh (stage B
    runs on one device in the port, as its single-device tests hold)."""
    from planted import build_planted_lut7

    from sboxgates_tpu.search import Options as JOptions
    from sboxgates_tpu.search import SearchContext as JSearchContext
    from sboxgates_tpu.search.context import LUT7_HEAD_SOLVE_ROWS
    from sboxgates_tpu.search.lut import _lut7_collect_hits as jcollect
    from sboxgates_tpu_torch.search.lut import _lut7_collect_hits

    st, target, mask = build_planted_lut7(22)
    jc = JSearchContext(JOptions(seed=1, lut_graph=True, randomize=False),
                        mesh_plan=JMeshPlan(jmake_mesh()))
    want = jcollect(jc, st, target, mask, [])
    tc = SearchContext(Options(seed=1, lut_graph=True, randomize=False,
                               device="cpu", native=False),
                       mesh_plan=_plan())
    got = _lut7_collect_hits(tc, _stream_state(22), target, mask, [])
    assert len(got[0]) > LUT7_HEAD_SOLVE_ROWS
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g).astype(np.int64),
                              np.asarray(w).astype(np.int64))
    assert tc.stats["lut7_candidates"] == jc.stats["lut7_candidates"]


def test_engine_continuation_under_mesh_equals_jax(shards):
    """The native engine drives the pivot-sized node under the mesh (no
    rendezvous there), its device work the sharded pivot stream: the
    circuit equals the JAX package's under its mesh."""
    from sboxgates_tpu.search import Options as JOptions
    from sboxgates_tpu.search import SearchContext as JSearchContext
    from sboxgates_tpu.search.kwan import create_circuit as jcreate
    from sboxgates_tpu_torch.search.kwan import create_circuit

    def gates(st):
        return [(g.type, g.in1, g.in2, g.in3, g.function) for g in st.gates]

    st, target, mask = build_planted_lut5()
    jc = JSearchContext(JOptions(seed=3, lut_graph=True, randomize=False),
                        mesh_plan=JMeshPlan(jmake_mesh()))
    jout = jcreate(jc, st, target, mask, [])
    tst = TState.init_inputs(8)
    for gt in build_planted_lut5()[0].gates[8:]:
        tst.add_gate(tbf.XOR, gt.in1, gt.in2, TGATES)
    tc = SearchContext(Options(seed=3, lut_graph=True, randomize=False,
                               device="cpu"), mesh_plan=_plan())
    tout = create_circuit(tc, tst, target, mask, [])
    assert tout == jout
    assert gates(tst) == gates(st)
    assert tc.stats["engine_devcalls"] >= 1
    assert tc.stats.get("python_nodes", 0) == 0


# -- the CLI ----------------------------------------------------------------

CLI = ["crypto1_fa_d8", "crypto1_fa_d8_dev", "g52_d8", "g52_d8_dev",
       "des_s1_d8", "des_s1_d8_dev", "fleet_c2_d8", "fleet_c2_d2_dev"]


def _run_port_cli(case, d, extra=()):
    from sboxgates_tpu_torch import cli

    argv, env, devices, procs = mg.CLI_CASES[case]
    assert procs == 1
    with environ(dict(env, **{tmesh.LOCAL_SHARDS_ENV: str(devices)})):
        return cli.main([*argv, *extra, "--device", "cpu", "--output-dir", d])


@pytest.mark.parametrize("case", CLI)
def test_mesh_cli_writes_the_jax_clis_files(case, tmp_path):
    """``--mesh`` on 8 shards writes the JAX CLI's files at 8 devices,
    byte for byte (XML and journals), on both routes."""
    d = str(tmp_path / case)
    assert _run_port_cli(case, d) == 0
    mg.compare_files(case, d)


def test_mesh_cli_equals_the_jax_cli_in_process(tmp_path, shards):
    """The crypto1 case against the JAX CLI run live in this process (8
    virtual devices), on the default route."""
    from sboxgates_tpu.cli import main as jmain

    argv = mg.CLI_CASES["crypto1_fa_d8"][0]
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    with environ({}):
        assert jmain([*argv, "--output-dir", jd]) == 0
    assert _run_port_cli("crypto1_fa_d8", td) == 0
    from torch_cli_helpers import marked, run_files

    want = {r: marked(b, r) for r, b in run_files(jd).items()}
    got = {r: marked(b, r) for r, b in run_files(td).items()}
    assert got == want
