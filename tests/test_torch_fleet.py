"""The job axis of the port, part 3: the fleet.

- ``fleet_bucket`` / ``prev_fleet_bucket`` against the JAX package's ladder,
  and the per-wave seed blocks of a fleet.
- The stacked lockstep steps (``fleet_gate_step``, ``fleet_lut_step``,
  ``fleet_lut7_step``, ``fleet_pivot_step``) against the JAX package's, on
  the same states (made with numpy from a seed in both packages), with the
  same context seed: ragged done lanes and pad lanes (3 jobs ride a jobs
  bucket of 4 lanes, each drawing a seed), randomized, so the verdicts
  also check the seed draws.  A step's second call must match too (the
  seed buffer advanced by the same count).
- The DES-8 fleet against the serial loop (the JAX package's
  ``tests/test_fleet.py`` parity), a device-route fleet whose sweeps merge,
  and the fleet CLI's files against the JAX CLI's (goldens of
  ``tests/torch_job_goldens.py``), including a fleet killed mid-run and
  resumed.

Tolerance: exact equality (integer verdicts and bytes).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sboxgates_tpu.core import boolfunc as jbf
from sboxgates_tpu.graph.state import GATES as JGATES
from sboxgates_tpu.graph.state import State as JState
from sboxgates_tpu.search import Options as JOptions
from sboxgates_tpu.search import SearchContext as JContext
from sboxgates_tpu.search import fleet as jfleet

from sboxgates_tpu_torch.core import ttable as tt
from sboxgates_tpu_torch.graph.state import GATES, State
from sboxgates_tpu_torch.search import Options, SearchContext
from sboxgates_tpu_torch.search import fleet as tfleet
from sboxgates_tpu_torch.search.multibox import (
    load_box_jobs,
    search_boxes_one_output,
)

from torch_cli_helpers import ROOT, compare_run, golden_case, run_files, \
    run_port_cli

torch.set_num_threads(1)


def test_jobs_buckets_match_the_jax_ladder():
    assert tfleet.FLEET_LADDER == jfleet.FLEET_LADDER
    for n in list(range(1, 70)) + [100, 255, 256, 257, 1000, 4096, 4097]:
        for shards in (1, 4):
            assert tfleet.fleet_bucket(n, shards) == jfleet.fleet_bucket(n, shards)
    for b in tfleet.FLEET_LADDER + (3, 5000):
        assert tfleet.prev_fleet_bucket(b) == jfleet.prev_fleet_bucket(b)


def test_a_fleet_draws_one_seed_block_per_wave():
    """8 jobs in waves of 3: the run's generator gives exactly three blocks
    of per-job seeds (3, 3, 2), in order, and nothing else."""
    ctx = SearchContext(Options(device="cpu", seed=21, lut_graph=True,
                                fleet=True, fleet_max_wave=3))
    boxes = tfleet.toy_fleet_boxes(8)
    search_boxes_one_output(ctx, boxes, 0, save_dir=None, log=lambda s: None)
    ref = np.random.default_rng(21)
    for n in (3, 3, 2):
        ref.integers(0, 2**31, size=n)
    assert ctx.rng.bit_generator.state == ref.bit_generator.state


def _grow_both(g, seed, n_in=8):
    """The same random gate state in both packages."""
    rng = np.random.default_rng(seed)
    jst, tst = JState.init_inputs(n_in), State.init_inputs(n_in)
    while jst.num_gates < g:
        a, b = rng.choice(jst.num_gates, size=2, replace=False)
        f = int(rng.choice([jbf.AND, jbf.OR, jbf.XOR]))
        jst.add_gate(f, int(a), int(b), JGATES)
        tst.add_gate(f, int(a), int(b), GATES)
    return jst, tst


def _contexts(lut, seed=3):
    j = JContext(JOptions(seed=seed, lut_graph=lut, host_small_steps=False,
                          native_engine=False))
    t = SearchContext(Options(device="cpu", seed=seed, lut_graph=lut,
                              native=False))
    return j, t


def _compare(jout, tout, width, miss_fields):
    """Row by row; a row whose step says "nothing found" compares only the
    fields the verdict specifies on a miss (``miss_fields``)."""
    assert jout.shape == tout.shape == (jout.shape[0], width)
    for a, b in zip(jout, tout):
        if int(a[0]) == 0:
            np.testing.assert_array_equal(a[miss_fields], b[miss_fields])
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("lut", [False, True])
def test_fleet_node_heads_match_the_jax_package(lut):
    jctx, tctx = _contexts(lut)
    mask = tt.mask_table(8)
    jobs_j, jobs_t = [], []
    for s, g in enumerate((20, 22, 20)):
        jst, tst = _grow_both(g, s)
        t = tst.table(12).copy() if s != 1 else tt.eval_lut(
            0x96, tst.table(1), tst.table(5), tst.table(g - 1))
        t = t ^ np.uint32(s == 2)
        jobs_j.append((jst, t, mask))
        jobs_t.append((tst, t, mask))
    jfn = jfleet.fleet_lut_step if lut else jfleet.fleet_gate_step
    tfn = tfleet.fleet_lut_step if lut else tfleet.fleet_gate_step
    width, miss = (8, [0, 6, 7]) if lut else (4, [0, 3])
    for done in ([False] * 3, [False, True, False]):
        _compare(jfn(jctx, jobs_j, done=done), tfn(tctx, jobs_t, done=done),
                 width, miss)


def test_fleet_lut7_step_matches_the_jax_package():
    jctx, tctx = _contexts(True, seed=5)
    mask = tt.mask_table(8)
    jobs_j, jobs_t = [], []
    for s in range(3):
        jst, tst = _grow_both(10, 10 + s)
        t = tst.live_tables()
        target = tt.eval_lut(0xCA, tt.eval_lut(0x6A, t[0], t[4], t[9]),
                             tt.eval_lut(0x3C, t[1], t[2], t[8]), t[5 + s])
        jobs_j.append((jst, target, mask))
        jobs_t.append((tst, target, mask))
    done = [False, True, False]
    _compare(jfleet.fleet_lut7_step(jctx, jobs_j, done=done),
             tfleet.fleet_lut7_step(tctx, jobs_t, done=done), 14, [0, 4])


def test_fleet_pivot_step_matches_the_jax_package():
    """The planted 50-gate node (tests/planted.py) as three jobs, tiles
    [16, 19) (the planted hit is tile 18) and [0, 3), a retired lane."""
    from planted import build_planted_lut5

    jctx, tctx = _contexts(True, seed=7)
    jst, target, mask = build_planted_lut5()
    # The same 50 gates in the port's State (tests/planted.py's draws).
    rng = np.random.default_rng(5)
    tst = State.init_inputs(8)
    while tst.num_gates < 50:
        a, b = rng.choice(tst.num_gates, size=2, replace=False)
        tst.add_gate(jbf.XOR, int(a), int(b), GATES)
    assert (tst.live_tables() == jst.live_tables()).all()
    jobs_j = [(jst.copy(), target.copy(), mask) for _ in range(3)]
    jobs_t = [(tst.copy(), np.asarray(target), np.asarray(mask))
              for _ in range(3)]
    for kw in (dict(done=[False, True, False], start_t=16, t_limit=3),
               dict(done=[False, False, True], t_limit=3)):
        j = jfleet.fleet_pivot_step(jctx, jobs_j, **kw)
        t = tfleet.fleet_pivot_step(tctx, jobs_t, **kw)
        np.testing.assert_array_equal(j, t)
    assert int(j[0][0]) == 0


DES = [os.path.join(ROOT, "sboxes", f"des_s{i}.txt") for i in range(1, 9)]


def _sig(res):
    return {k: [(s.num_gates, s.live_tables().tobytes()) for s in v]
            for k, v in res.items()}


def test_fleet_parity_des8_vs_serial():
    """All 8 DES boxes, output 0, as one fleet: the serial loop's circuits
    (randomization off, as the JAX package's test)."""
    ser = SearchContext(Options(device="cpu", seed=11, lut_graph=True,
                                randomize=False))
    res_s = search_boxes_one_output(ser, load_box_jobs(DES), 0, save_dir=None,
                                    log=lambda s: None, batched=False)
    flt = SearchContext(Options(device="cpu", seed=11, lut_graph=True,
                                randomize=False, fleet=True))
    res_f = search_boxes_one_output(flt, load_box_jobs(DES), 0, save_dir=None,
                                    log=lambda s: None)
    assert _sig(res_f) == _sig(res_s)
    assert all(res_f.values())


def test_device_route_fleet_merges_and_matches_the_serial_loop():
    """Toy boxes on the device route: the fleet's sweeps merge (fewer
    rounds than submits, lane forms of several lanes) and its circuits are
    the serial loop's."""
    opts = dict(device="cpu", seed=11, lut_graph=True, randomize=False,
                native=False)
    ser = SearchContext(Options(**opts))
    res_s = search_boxes_one_output(ser, tfleet.toy_fleet_boxes(), 0,
                                    save_dir=None, log=lambda s: None,
                                    batched=False)
    flt = SearchContext(Options(fleet=True, **opts))
    res_f = search_boxes_one_output(flt, tfleet.toy_fleet_boxes(), 0,
                                    save_dir=None, log=lambda s: None)
    assert _sig(res_f) == _sig(res_s)
    st = flt.stats
    assert st["fleet_submits"] > st["fleet_rounds"] >= 1
    assert st["fleet_dispatches"] >= 1
    assert st["fleet_lanes"] >= 2 * st["fleet_dispatches"]


@pytest.mark.parametrize("case", [
    "fleet_crypto_dev_o0", "fleet_des8_lut_o0", "fleet_ps_crypto1_fa_wave4",
    "fleet_des12_all",
])
def test_fleet_writes_the_jax_clis_files(case, tmp_path):
    argv, env = golden_case(case)
    run_port_cli(argv, env, str(tmp_path / "d"))
    compare_run(case, str(tmp_path / "d"))


def _port_process(argv, env):
    e = dict(os.environ, PYTHONPATH=ROOT)
    for k in ("SBG_DISABLE_NATIVE", "SBG_FAULTS", "SBG_ENGINE_MUX_THREADS"):
        e.pop(k, None)
    e.update(env)
    return subprocess.run(
        [sys.executable, "-m", "sboxgates_tpu_torch", *argv, "--device", "cpu"],
        env=e, capture_output=True, text=True,
    ).returncode


def test_killed_fleet_resumes_to_the_uninterrupted_files(tmp_path):
    """A fleet over two DES boxes (all outputs), killed by a real crash at
    its second round boundary: the directory the JAX CLI leaves at the
    same crash, then, resumed, the uninterrupted run's files."""
    argv, env = golden_case("fleet_des12_all")
    d = str(tmp_path / "d")
    assert _port_process([*argv, "--output-dir", d],
                         dict(env, SBG_FAULTS="search.round:crash@2")) == 17
    compare_run("fleet_des12_all_killed", d)
    assert _port_process(["--resume-run", d], env) == 0
    compare_run("fleet_des12_all", d)
    assert len([r for r in run_files(d) if r.endswith(".xml")]) > 4
