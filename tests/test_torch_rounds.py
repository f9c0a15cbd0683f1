"""The chained rounds of the port against the JAX package's.

- ``round_driver`` and ``fleet_round_driver`` (``ops/sweeps.py``) against
  the jitted JAX drivers on seeded random tables at g = 8 to 49, with
  random targets and planted hits of every kind (an existing gate, its
  complement, a 3-LUT, a 5-LUT), a miss and a head-solver overflow, row
  for row: kinds, operands, the examined counts ``ex3``/``ex5`` and the
  tail row.  Each lane of a merged call equals its one-row call.
- ``run_round_chain`` and ``run_fleet_round_chains`` (``search/rounds.py``)
  against the JAX package's on its planted chains (``tests/planted.py``):
  output gates, gate lists and PRNG positions, for several
  rounds-per-dispatch values, with a host-fallback lane; and windows
  merged through a fleet rendezvous (the serve wave's shape).
- The CLI's ``--chain-rounds`` runs against the JAX CLI's files (goldens of
  ``tests/torch_round_goldens.py``): a planted chain at N = 1 and 4 on both
  routes, and a chain killed after its second round, resumed.

Tolerance: exact equality (integer words, verdicts and bytes).
"""

import os
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sboxgates_tpu.core import ttable as jtt
from sboxgates_tpu.ops import combinatorics as jcomb
from sboxgates_tpu.ops import sweeps as jsw
from sboxgates_tpu.search import Options as JOptions
from sboxgates_tpu.search import SearchContext as JContext
from sboxgates_tpu.search import context as jctx
from sboxgates_tpu.search import rounds as jrounds
from sboxgates_tpu.search.serve import JobView as JJobView

from sboxgates_tpu_torch.graph.state import State
from sboxgates_tpu_torch.ops import sweeps as tsw
from sboxgates_tpu_torch.search import Options, SearchContext
from sboxgates_tpu_torch.search import rounds as trounds
from sboxgates_tpu_torch.search import warmup as twarmup
from sboxgates_tpu_torch.search.fleet import FleetRendezvous, fleet_stats_into
from sboxgates_tpu_torch.search.serve import JobView

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from planted import build_round_chain  # noqa: E402
from torch_cli_helpers import environ  # noqa: E402
from torch_states import random_state  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_golden", "rounds")


def W(a):
    return tsw.as_words(a, CPU)


# -- the drivers ------------------------------------------------------------


def _targets(st, kinds, seed):
    """One (target, mask) per kind over the state as the rounds grow it:
    planted hits are built on the simulated state, so later rounds see the
    gates earlier rounds append."""
    rng = np.random.default_rng(seed)
    sim = st.copy()
    mask = jtt.mask_table(8)
    out = []
    for k in kinds:
        t = sim.live_tables()
        n = sim.num_gates
        if k == "direct":
            tgt = t[int(rng.integers(n))]
        elif k == "comp":
            a = int(rng.integers(n))
            tgt = ~t[a]
            sim.add_not_gate(a, 0)
        elif k == "lut3":
            a, b, c = sorted(int(x) for x in rng.choice(n, 3, replace=False))
            f = int(rng.integers(1, 255))
            tgt = jtt.eval_lut(f, t[a], t[b], t[c])
            sim.add_lut(f, a, b, c)
        elif k == "lut5":
            a, b, c, d, e = (int(x) for x in rng.choice(n, 5, replace=False))
            o = sim.add_lut(0x2D, a, b, c)
            sim.add_lut(0xB4, o, d, e)
            tgt = sim.live_tables()[-1]
        elif k == "rand5":
            # A random function of 5 gates: feasible tuples that do not
            # decompose (with one solver row, an overflow).
            gs = [int(x) for x in rng.choice(n, 5, replace=False)]
            f = rng.integers(0, 2, 32).astype(bool)
            idx = sum(jtt.to_bits(t[x]).astype(int) << (4 - i)
                      for i, x in enumerate(gs))
            tgt = jtt.from_bits(f[idx])
        else:
            tgt = rng.integers(0, 2**32, 8, dtype=np.uint64).astype(np.uint32)
        out.append((np.asarray(tgt, np.uint32), mask))
    return out


def _window(st, rounds, seeds, dcs, rb):
    g = st.num_gates
    n = len(rounds)
    b = 64 if g + 2 * n <= 64 else 512
    tg = np.zeros((rb, 8), np.uint32)
    mk = np.zeros((rb, 8), np.uint32)
    for i, (t, m) in enumerate(rounds):
        tg[i], mk[i] = t, m
    ws = np.zeros(rb, np.int32)
    wd = np.zeros(rb, np.int32)
    ws[:n], wd[:n] = seeds[:n], dcs[:n]
    pad = np.zeros((b, 8), np.uint32)
    pad[:g] = st.live_tables()
    return pad, g, tg, mk, ws, wd, n


def _statics(b, rb, solve_rows=1024):
    return dict(
        chunk3=jctx.pick_chunk(jcomb.n_choose_k(b, 3), jctx.STREAM_CHUNK[3]),
        chunk5=jctx.pick_chunk(jctx.PIVOT_MIN_TOTAL, jctx.STREAM_CHUNK[5]),
        has5=True, max_rounds=rb, solve_rows=solve_rows,
    )


SPLITS, W_TAB, M_TAB = jsw.lut5_split_tables()
EXCL = np.full(8, -1, np.int32)

#: (gate count, round kinds, head-solver rows, the kinds of the rows the
#: driver fills): every hit kind, a miss at the start and in the middle of
#: a window, 5-LUT spaces from C(8, 5) to C(49, 5) (16 chunks at g = 49),
#: and an overflow.
DRIVER_CASES = [
    (12, ["direct", "comp", "lut3", "lut5", "rand", "lut3"], 1024,
     [1, 2, 3, 4, 0]),
    (30, ["lut3", "lut5", "comp", "lut3"], 1024, [3, 3, 2, 3]),
    (30, ["rand5", "lut3"], 1, [5]),
    (8, ["rand", "lut3"], 1024, [0]),
    (40, ["lut5", "lut3", "rand"], 1024, [3, 3, 0]),
    (49, ["rand"], 1024, [0]),
]

#: (case, seed): both seeds for each case but the whole g = 49 space.
DRIVER_PARAMS = [(c, s) for c in range(len(DRIVER_CASES)) for s in (-1, 4242)
                 if (c, s) != (len(DRIVER_CASES) - 1, 4242)]


def _driver_case(i, seed):
    g, kinds, sr, _ = DRIVER_CASES[i]
    st = random_state(g, 100 + i)
    rounds = _targets(st, kinds, 200 + i)
    rng = np.random.default_rng(seed & 0xFFFF)
    seeds = (np.full(8, -1, np.int32) if seed < 0
             else rng.integers(0, 2**31, 8).astype(np.int32))
    dcs = rng.integers(0, 256, 8).astype(np.int32)
    return st, rounds, seeds, dcs, sr


def _jax_driver(pad, g, tg, mk, ws, wd, n, statics):
    return np.asarray(jsw.round_driver(
        jnp.asarray(pad), jnp.asarray(jsw.binom_table()), g, jnp.asarray(tg),
        jnp.asarray(mk), jnp.asarray(EXCL), jnp.asarray(ws), jnp.asarray(wd),
        n, jctx.PIVOT_MIN_TOTAL, jnp.asarray(SPLITS), jnp.asarray(W_TAB),
        jnp.asarray(M_TAB), **statics,
    ))


def _port_row(pad, g, tg, mk, ws, wd, n):
    return (W(pad), tsw.binom_device(CPU), g, W(tg), W(mk),
            torch.from_numpy(EXCL), ws, wd, n, jctx.PIVOT_MIN_TOTAL, SPLITS,
            W(W_TAB), W(M_TAB))


@pytest.mark.parametrize("case,seed", DRIVER_PARAMS)
def test_round_driver_matches_jax(case, seed):
    st, rounds, seeds, dcs, sr = _driver_case(case, seed)
    rb = trounds.round_bucket(len(rounds))
    win = _window(st, rounds, seeds, dcs, rb)
    statics = _statics(win[0].shape[0], rb, sr)
    want = _jax_driver(*win, statics)
    got = tsw.round_driver(*_port_row(*win), **statics)
    np.testing.assert_array_equal(got, want)
    done = int(got[rb, 0])
    assert [int(k) for k in got[: done + (done < len(rounds)), 0]] == \
        DRIVER_CASES[case][3]


def test_driver_cases_cover_every_kind():
    assert {k for c in DRIVER_CASES for k in c[3]} == {0, 1, 2, 3, 4, 5}


def test_fleet_round_driver_matches_jax_lane_by_lane():
    """Ragged lanes: four chains of different gate counts and lengths on
    one table bucket, one frozen lane (n_rounds 0) and one pad lane; the
    stacked call equals the JAX package's, and each lane its one-row
    call."""
    b, rb = 64, 8
    lanes = []
    for i, (g, kinds) in enumerate([
        (12, ["lut3", "comp", "lut5", "direct"]),
        (20, ["lut5", "rand", "lut3"]),
        (9, ["direct"]),
        (30, ["lut3", "lut3", "lut5", "comp", "lut3", "rand"]),
    ]):
        st = random_state(g, 300 + i)
        rounds = _targets(st, kinds, 400 + i)
        rng = np.random.default_rng(i)
        seeds = rng.integers(0, 2**31, rb).astype(np.int32)
        dcs = rng.integers(0, 256, rb).astype(np.int32)
        pad, g0, tg, mk, ws, wd, n = _window(st, rounds, seeds, dcs, rb)
        lanes.append((pad, g0, tg, mk, ws, wd, 0 if i == 2 else n))
    lanes.append((np.zeros((b, 8), np.uint32), 0, np.zeros((rb, 8), np.uint32),
                  np.zeros((rb, 8), np.uint32), np.zeros(rb, np.int32),
                  np.zeros(rb, np.int32), 0))
    stack = [np.stack([ln[k] for ln in lanes]) for k in range(7)]
    statics = _statics(b, rb)
    want = np.asarray(jsw.fleet_round_driver(
        jnp.asarray(stack[0]), jnp.asarray(jsw.binom_table()),
        jnp.asarray(stack[1].astype(np.int32)), jnp.asarray(stack[2]),
        jnp.asarray(stack[3]), jnp.asarray(EXCL), jnp.asarray(stack[4]),
        jnp.asarray(stack[5]), jnp.asarray(stack[6].astype(np.int32)),
        jctx.PIVOT_MIN_TOTAL, jnp.asarray(SPLITS), jnp.asarray(W_TAB),
        jnp.asarray(M_TAB), **statics,
    ))
    got = tsw.fleet_round_driver(
        W(stack[0]), tsw.binom_device(CPU), stack[1], W(stack[2]),
        W(stack[3]), torch.from_numpy(EXCL), stack[4], stack[5], stack[6],
        jctx.PIVOT_MIN_TOTAL, SPLITS, W(W_TAB), W(M_TAB), **statics,
    )
    np.testing.assert_array_equal(got, want)
    for i, ln in enumerate(lanes):
        one = tsw.round_driver(*_port_row(*ln), **statics)
        np.testing.assert_array_equal(got[i], one)
    assert got[2, rb, 0] == 0 and got[4, rb, 0] == 0


def test_registry_declares_the_round_drivers():
    for name in ("round_driver", "fleet_round_driver"):
        d = twarmup.KERNELS[name]
        assert d.static_names == ("chunk3", "chunk5", "has5", "max_rounds",
                                  "solve_rows")
        assert callable(d.fn)
    assert twarmup.KERNELS["round_driver"].lanes is tsw.round_driver_lanes
    from sboxgates_tpu.search import warmup as jwarmup

    assert twarmup.FLEET_SHARED == jwarmup.FLEET_SHARED


def test_chain_buckets_match_jax():
    assert trounds.ROUND_BUCKETS == jrounds.ROUND_BUCKETS
    for n in range(0, 40):
        assert trounds.round_bucket(n) == jrounds.round_bucket(n)
    for g in (6, 40, 60, 63, 64, 300, 505, 508, 510):
        for want in (1, 4, 8, 32):
            try:
                j = jrounds._chain_bucket(g, want)
            except ValueError:
                with pytest.raises(ValueError):
                    trounds._chain_bucket(g, want)
                continue
            assert trounds._chain_bucket(g, want) == j


# -- the chain drivers --------------------------------------------------------


def _port_state(jst):
    st = State.init_inputs(jst.num_inputs)
    for g in jst.gates[jst.num_inputs:]:
        st.replay_gate(int(g.type), int(g.in1), int(g.in2), int(g.in3),
                       int(g.function))
    return st


def _sig(st):
    return (
        np.asarray(st.live_tables()).tobytes(),
        tuple((int(g.type), int(g.in1), int(g.in2), int(g.in3),
               int(g.function)) for g in st.gates),
    )


def _jctx(seed=5):
    return JContext(JOptions(
        lut_graph=True, randomize=True, seed=seed, warmup=False,
        parallel_mux=False, native_engine=False, host_small_steps=False,
    ))


def _tctx(seed=5):
    return SearchContext(Options(
        lut_graph=True, randomize=True, seed=seed, device="cpu",
        parallel_mux=False, native=False,
    ))


def _lane_case(i):
    """The JAX package's fleet-rounds lanes: lane 2 ends in a target the
    driver cannot finish (its host-fallback round)."""
    if i == 2:
        return build_round_chain(n_rounds=2, gates0=8, seed=22, deep_last=True)
    return build_round_chain(n_rounds=6, gates0=12, seed=20 + i)


def _snap(ctx):
    s = ctx.rng_snapshot()
    return (repr(s["bg"]), tuple(s["seed_buf"]))


@pytest.fixture(scope="module")
def jax_chains():
    """The JAX package's run_round_chain on each lane alone."""
    base = _jctx()
    refs = []
    for i in range(4):
        jst, rounds = _lane_case(i)
        v = JJobView(base, 1000 + i)
        outs = jrounds.run_round_chain(v, jst, rounds, rounds_per_dispatch=4)
        refs.append((tuple(outs), _sig(jst), _snap(v),
                     int(v.stats["lut3_candidates"]),
                     int(v.stats["lut5_candidates"])))
    return refs


@pytest.mark.parametrize("rpd", [1, 4, 8])
def test_run_round_chain_matches_jax(jax_chains, rpd):
    base = _tctx()
    for i in range(4):
        jst, rounds = _lane_case(i)
        st = _port_state(jst)
        v = JobView(base, 1000 + i)
        outs = trounds.run_round_chain(v, st, rounds, rounds_per_dispatch=rpd)
        got = (tuple(outs), _sig(st), _snap(v),
               int(v.stats["lut3_candidates"]),
               int(v.stats["lut5_candidates"]))
        assert got == jax_chains[i], (i, rpd)
        assert v.stats["round_driver_fallbacks"] == (1 if i == 2 else 0)


def test_fleet_round_chains_match_jax(jax_chains):
    """Four lanes in lockstep, one with a host-fallback round: each lane's
    circuit, outputs and PRNG position are its lone chain's, in few
    dispatches."""
    base = _tctx()
    lanes = []
    for i in range(4):
        jst, rounds = _lane_case(i)
        lanes.append((JobView(base, 1000 + i), _port_state(jst), rounds))
    outs = trounds.run_fleet_round_chains(base, lanes, rounds_per_dispatch=4)
    for i, (v, st, _) in enumerate(lanes):
        assert (tuple(outs[i]), _sig(st), _snap(v),
                int(v.stats["lut3_candidates"]),
                int(v.stats["lut5_candidates"])) == jax_chains[i]
    assert base.stats["device_dispatches"] <= 4


def test_rendezvous_merged_chain_windows(jax_chains):
    """Three lanes running plain run_round_chain over one fleet rendezvous
    (a merged serve wave): their windows merge into lane-form calls, and
    each lane's result is its lone chain's."""
    base = _tctx()
    rdv = FleetRendezvous(3)
    results = [None] * 3
    errors = []

    def worker(i):
        try:
            jst, rounds = _lane_case(i)
            st = _port_state(jst)
            v = JobView(base, 1000 + i, rdv=rdv)
            outs = trounds.run_round_chain(v, st, rounds, rounds_per_dispatch=4)
            results[i] = (tuple(outs), _sig(st), _snap(v),
                          int(v.stats["lut3_candidates"]),
                          int(v.stats["lut5_candidates"]))
        except BaseException as e:
            errors.append(e)
        finally:
            rdv.finish()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for i in range(3):
        assert results[i] == jax_chains[i], i
    fleet_stats_into(base, rdv)
    assert base.stats["fleet_submits"] >= 3
    assert base.stats["fleet_dispatches"] >= 1
    assert (base.stats["fleet_dispatches"] + base.stats["fleet_singletons"]
            < base.stats["fleet_submits"])


def test_a_window_that_exhausts_its_deadline_degrades_to_the_host(monkeypatch):
    """A hung round window: the deadline's retries run out, the breaker
    trips and the chain completes on the host fallback, every round's
    output realizing its target."""
    from sboxgates_tpu_torch.resilience import faults

    jst, rounds = _lane_case(0)
    ctx = _tctx()
    ctx.deadline_cfg.budget_s = 0.2
    ctx.deadline_cfg.retries = 0
    ctx.deadline_cfg.backoff_s = 0.0
    faults.arm("dispatch.sweep", "hang", "1+")
    try:
        st = _port_state(jst)
        outs = trounds.run_round_chain(ctx, st, rounds, rounds_per_dispatch=4)
    finally:
        faults.disarm()
    assert ctx.device_degraded and ctx.stats["circuit_breaker_trips"] == 1
    assert ctx.stats["round_driver_fallbacks"] == len(rounds)
    assert len(outs) == len(rounds)
    for (t, m), o in zip(rounds, outs):
        assert bool(jtt.eq_mask(st.table(o), t, m))


# -- the CLI --------------------------------------------------------------------


#: The chain CLI cases the CPU runs (DES S1's are the card's).
CLI_CASES = ["planted_n4", "planted_n1", "planted_n4_dev", "planted_n1_dev"]


@pytest.mark.parametrize("case", CLI_CASES)
def test_chain_cli_writes_the_jax_clis_files(case, tmp_path):
    from torch_round_goldens import CASES, compare_dir, golden_dir, run_port

    argv, env, _ = CASES[case][1][0]
    d = str(tmp_path / case)
    run_port(argv, env, d)
    compare_dir(golden_dir(case), d)


def test_chain_files_do_not_depend_on_the_window(tmp_path):
    """N = 1 and N = 4 write the same XML; the journals differ only in the
    recorded chain_rounds."""
    from torch_round_goldens import files_of

    a = files_of(os.path.join(GOLDEN, "planted_n1"))
    b = files_of(os.path.join(GOLDEN, "planted_n4"))
    assert {k: v for k, v in a.items() if k.endswith(".xml")} == {
        k: v for k, v in b.items() if k.endswith(".xml")}
    ja = a["search.journal.jsonl"].replace(b'"chain_rounds": 1',
                                            b'"chain_rounds": 4')
    assert ja == b["search.journal.jsonl"]


def test_a_killed_chain_resumes_to_the_uninterrupted_files(tmp_path):
    from sboxgates_tpu_torch import cli
    from torch_round_goldens import compare_dir, paste_golden

    d = str(tmp_path / "killed")
    paste_golden(os.path.join(GOLDEN, "planted_n4_killed"), d)
    with environ({}):
        assert cli.main(["--resume-run", d, "--device", "cpu"]) == 0
    compare_dir(os.path.join(GOLDEN, "planted_n4"), d)
