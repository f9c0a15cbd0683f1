"""The fleet's job shards, each launching its lanes on its own device
(``ops/sweeps.py: job_shards``, entered by ``search/fleet.py:
call_lanes`` under a ``parallel/mesh.py: FleetPlan`` of several job
shards).

- The CLI on four job shards (``SBG_LOCAL_SHARDS=4``, device route)
  against the JAX CLI's files at 4 devices (goldens of
  ``tests/torch_mesh_goldens.py``): the G = 99 resume's 8 restarts (K1's
  lane form) and, marked slow, the DES-8 fleet (K3's lane form; the
  default run of ``chip_smoke.py`` holds it on the card, phase 14f),
  every job shard launching its lane form.
- The block layout (``P("jobs")``'s blocks) of a launch's lanes, for
  stacked calls, merged groups of fewer lanes than shards or of a ragged
  count, and a round's live lanes; each block launched once under its
  shard's device context, its operands on that device, the outputs
  gathered in lane order.
- Lane forms split against the unsplit call: the same verdicts, and the
  same host syncs (one per round for all lanes, the CPU sync guard).
- A launch that raises: the call raises, and nothing runs again.
- The fleet's counters (one dispatch per call) with and without the
  split, and the stacked steps under a 4-job-shard plan against the JAX
  package's under its own.

Tolerance: exact equality (integer verdicts, file bytes).
"""

import contextlib
import math
import os
import sys

import jax
import numpy as np
import pytest
import torch

from sboxgates_tpu.parallel import FleetPlan as JFleetPlan
from sboxgates_tpu.parallel import make_fleet_mesh as jmake_fleet_mesh
from sboxgates_tpu.search import Options as JOptions
from sboxgates_tpu.search import SearchContext as JContext
from sboxgates_tpu.search import fleet as jfleet

from sboxgates_tpu_torch import cli
from sboxgates_tpu_torch.core import ttable as tt
from sboxgates_tpu_torch.ops import sweeps
from sboxgates_tpu_torch.parallel import mesh as tmesh
from sboxgates_tpu_torch.search import Options, SearchContext
from sboxgates_tpu_torch.search import fleet as tfleet
from sboxgates_tpu_torch.search.multibox import search_boxes_one_output
from sboxgates_tpu_torch.utils.guards import sync_guard

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mesh_goldens as mg  # noqa: E402
from test_torch_batched import _pivot_rows, rand_state  # noqa: E402
from test_torch_fleet import _compare, _grow_both, _sig  # noqa: E402
from torch_cli_helpers import environ  # noqa: E402

CPU = torch.device("cpu")
K3L, K1L = "lut5_filter_lanes", "pivot_window_lanes"
CLI_THREADS = 4


def _plan(devices, candidates=1):
    return tmesh.FleetPlan(tmesh.make_fleet_mesh(devices, candidates))


@pytest.fixture
def counts():
    """The lane-form launches by job shard, zeroed for the test."""
    sweeps.JOB_SHARD_LAUNCHES.clear()
    yield sweeps.JOB_SHARD_LAUNCHES
    sweeps.JOB_SHARD_LAUNCHES.clear()


# -- the CLI on four job shards ----------------------------------------------


@pytest.mark.parametrize("case,kernel", [
    pytest.param("fleet_des8_d4_dev", K3L, marks=pytest.mark.slow),
    ("fleet_g99_i8_d4_dev", K1L),
])
def test_four_job_shards_write_the_jax_clis_files(case, kernel, counts,
                                                  tmp_path):
    """``--fleet`` on four local shards writes the JAX CLI's files at 4
    devices, byte for byte (XML and journals), and every job shard
    launched its part of the fleet's lane form."""
    argv, env, devices, procs = mg.CLI_CASES[case]
    assert (devices, procs) == (4, 1)
    d = str(tmp_path / case)
    threads = torch.get_num_threads()
    # The plain K1 over the restarts' 1,016 tiles: several cores' work.
    torch.set_num_threads(CLI_THREADS)
    try:
        with environ(dict(env, **{tmesh.LOCAL_SHARDS_ENV: str(devices)})):
            assert cli.main([*argv, "--device", "cpu", "--output-dir",
                             d]) == 0
    finally:
        torch.set_num_threads(threads)
    mg.compare_files(case, d)
    by = counts[kernel]
    assert sorted(by) == [0, 1, 2, 3] and min(by.values()) >= 1, counts


# -- the block layout and the split -------------------------------------------


@pytest.mark.parametrize("devices,candidates,rows,n,want", [
    # a stacked call: lanes a multiple of the job shards, n / J each
    (8, 2, range(8), 8, [(0, 0, 2), (1, 2, 4), (2, 4, 6), (3, 6, 8)]),
    (4, 1, range(4), 4, [(0, 0, 1), (1, 1, 2), (2, 2, 3), (3, 3, 4)]),
    # merged groups: fewer lanes than shards, and ragged counts
    (4, 1, range(3), 3, [(0, 0, 1), (1, 1, 2), (2, 2, 3)]),
    (4, 1, range(6), 6, [(0, 0, 2), (1, 2, 4), (2, 4, 6)]),
    (4, 1, range(5), 5, [(0, 0, 2), (1, 2, 4), (2, 4, 5)]),
    (2, 1, range(7), 7, [(0, 0, 4), (1, 4, 7)]),
    # a round's live lanes: rows 1, 4, 5 and 7 of an 8-row call
    (4, 1, [1, 4, 5, 7], 8, [(0, 0, 1), (2, 1, 3), (3, 3, 4)]),
])
def test_blocks_follow_the_jobs_axis_layout(devices, candidates, rows, n,
                                            want):
    plan = _plan([torch.device("cuda", i) for i in range(devices)],
                 candidates)
    assert plan.n_job_shards == devices // candidates
    # Job shard j owns local[j*C:(j+1)*C] and runs on the first of them.
    assert plan.job_devices == [torch.device("cuda", j * candidates)
                                for j in range(plan.n_job_shards)]
    assert sweeps.job_blocks(rows, n) is None
    with sweeps.job_shards(plan.job_devices):
        got = sweeps.job_blocks(rows, n)
    assert got == [(j, plan.job_devices[j], lo, hi) for j, lo, hi in want]


@pytest.fixture
def placed(monkeypatch):
    """Job shard j's device is cpu:j, and every launch records the device
    context it ran under and its operands' rows."""
    devices = [torch.device("cpu", j) for j in range(4)]
    state = {"current": None, "launches": []}

    @contextlib.contextmanager
    def ctx(dev):
        prev, state["current"] = state["current"], dev
        try:
            yield
        finally:
            state["current"] = prev

    monkeypatch.setattr(sweeps, "device_ctx", ctx)
    for name, kernel in (("lut5_filter_cells_lanes", K3L),
                         ("pivot_window_lanes", K1L)):
        real = getattr(sweeps, name)

        def launch(*a, _real=real, _name=kernel, **k):
            state["launches"].append((_name, state["current"], a[0].shape[0]))
            return _real(*a, **k)

        monkeypatch.setattr(sweeps, name, launch)
    return devices, state


@pytest.mark.parametrize("rows,n", [(range(8), 8), (range(3), 3),
                                    ([0, 3, 6, 7], 8)])
def test_k3_lane_form_launches_once_per_job_shard_in_lane_order(
        rows, n, placed, counts):
    """K3's lane form under four job shards: one launch per block under
    its shard's device, and the outputs those of the unsplit launch, in
    lane order."""
    devices, state = placed
    rng = np.random.default_rng(5)
    lanes = len(rows)
    tables = torch.from_numpy(rng.integers(-2**31, 2**31, (lanes, 12, 8),
                                           dtype=np.int64).astype(np.int32))
    combos = torch.from_numpy(rng.integers(0, 12, (lanes, 64, 5),
                                           dtype=np.int64).astype(np.int32))
    target = torch.from_numpy(rng.integers(-2**31, 2**31, (lanes, 8),
                                           dtype=np.int64).astype(np.int32))
    mask = torch.full((lanes, 8), -1, dtype=torch.int32)
    want = sweeps._filter5(tables, combos, target, mask, True)
    state["launches"].clear()
    with sweeps.job_shards(devices):
        got = sweeps._filter5(tables, combos, target, mask, True, rows, n)
        blocks = sweeps.job_blocks(rows, n)
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    assert state["launches"] == [(K3L, devices[j], hi - lo)
                                 for j, _, lo, hi in blocks]
    assert counts == {K3L: {j: 1 for j, _, _, _ in blocks}}


def test_k1_lane_form_launches_once_per_job_shard_per_window(placed, counts):
    """K1's lane form under four job shards: each window one launch per
    shard under its device, and the verdicts the unsplit call's."""
    devices, state = placed
    rows = _pivot(8)
    statics = {"tl": 16, "th": 16}
    want = sweeps.lut5_pivot_stream_lanes(rows, **statics)
    windows = len(state["launches"])
    state["launches"].clear()
    with sweeps.job_shards(devices):
        got = sweeps.lut5_pivot_stream_lanes(rows, **statics)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert windows >= 1
    assert state["launches"] == [(K1L, devices[j], 2)
                                 for _ in range(windows) for j in range(4)]
    assert counts == {K1L: {j: windows for j in range(4)}}


def test_without_a_plan_or_with_one_job_shard_the_call_is_not_split(counts):
    rows = [(i,) for i in range(5)]
    seen = []

    def lanes_fn(r, *, k):
        seen.append((r, sweeps.job_blocks(range(len(r)), len(r))))
        return [x[0] * k for x in r]

    for plan in (None, _plan([CPU])):
        assert tfleet.call_lanes(plan, lanes_fn, rows, {"k": 3}) == \
            [0, 3, 6, 9, 12]
    assert seen == [(rows, None)] * 2
    plan = _plan([CPU] * 4)
    assert tfleet.call_lanes(plan, lanes_fn, rows, {"k": 1}) == list(range(5))
    assert seen[-1][1] == [(0, CPU, 0, 2), (1, CPU, 2, 4), (2, CPU, 4, 5)]
    assert sweeps.job_blocks(range(5), 5) is None
    assert counts == {}


def test_a_failing_launch_raises_and_nothing_runs_again(placed, counts,
                                                        monkeypatch):
    """A job shard's launch that raises makes the call raise; no block is
    launched again, on the first device or any other."""
    devices, state = placed
    real = sweeps.lut5_filter_cells_lanes

    def launch(*a, **k):
        if state["current"] == devices[2]:
            raise RuntimeError("job shard 2 failed")
        return real(*a, **k)

    monkeypatch.setattr(sweeps, "lut5_filter_cells_lanes", launch)
    rows = _lut5_rows(8)
    with sweeps.job_shards(devices), \
            pytest.raises(RuntimeError, match="job shard 2 failed"):
        sweeps.lut5_stream_lanes(rows, chunk=1024)
    assert [d for _, d, _ in state["launches"]] == devices[:2]
    assert counts == {K3L: {0: 1, 1: 1}}


# -- lane forms split against the unsplit call -------------------------------


def _lut5_rows(lanes):
    rng = np.random.default_rng(19)
    mask = sweeps.as_words(tt.mask_table(8), CPU)
    binom = sweeps.binom_device(CPU)
    _, w_tab, m_tab = sweeps.lut5_split_tables()
    jw, jm = sweeps.as_words(w_tab, CPU), sweeps.as_words(m_tab, CPU)
    rows = []
    for i in range(lanes):
        tabs = np.zeros((64, 8), np.uint32)
        g = 10 + i % 2
        tabs[:g] = rand_state(rng, 8, g).live_tables()
        rows.append((sweeps.as_words(tabs, CPU), binom, g,
                     sweeps.as_words(rng.integers(0, 2**32, 8,
                                                  dtype=np.uint32), CPU),
                     mask, torch.full((8,), -1, dtype=torch.int32), 0,
                     math.comb(g, 5), jw, jm, 5 + i))
    return rows


def _pivot(lanes):
    rng = np.random.default_rng(19)
    out = []
    for r in _pivot_rows(rng, (12,) * (2 * lanes), 16, 16)[::2]:
        hit = int(sweeps.lut5_pivot_stream(*r, tl=16, th=16)[8]) - 1
        out.append(r[:7] + (hit, hit + 1) + r[9:])
    return out


# (rows, lane form, statics, host syncs of one round of one call, kernel,
# host syncs of one launch of the kernel's plain version: K1's lane form
# reads its descriptors to the host, a CPU copy that waits on no device)
LANE_FORMS = {
    "lut5_stream": (_lut5_rows, sweeps.lut5_stream_lanes, {"chunk": 1024}, 1,
                    K3L, 0),
    "lut5_pivot_stream": (_pivot, sweeps.lut5_pivot_stream_lanes,
                          {"tl": 16, "th": 16}, 3, K1L, 1),
}


@pytest.mark.parametrize("name", sorted(LANE_FORMS))
def test_split_lane_forms_match_the_unsplit_call_with_its_syncs(name, counts):
    """Eight lanes of one round on four job shards: the unsplit call's
    verdicts, lane by lane, and its host syncs (as
    ``test_one_merged_round_syncs_once_for_all_lanes`` counts them for
    one call): the split adds none but the plain version's own, one per
    launch of it beyond the unsplit call's (one launch per shard where the
    unsplit call makes one)."""
    make, fn, statics, syncs, kernel, plain = LANE_FORMS[name]
    rows = make(8)
    with sync_guard(action="count") as rep:
        want = fn(rows, **statics)
    assert rep.syncs == syncs
    with sync_guard(action="count") as rep, sweeps.job_shards([CPU] * 4):
        got = fn(rows, **statics)
    assert len(got) == len(want) == 8
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    by = counts[kernel]
    assert sorted(by) == [0, 1, 2, 3] and len(set(by.values())) == 1
    assert rep.syncs == syncs + plain * (sum(by.values()) - by[0])


# -- the fleet with and without the split -------------------------------------


@pytest.mark.parametrize("lut", [False, True])
def test_fleet_counters_are_one_per_call_with_and_without_the_split(
        lut, monkeypatch):
    """Toy boxes on the device route as one fleet, unsplit and on four job
    shards: the same circuits and the same dispatch counters (a split call
    is one dispatch), each merged or stacked call run under the shards."""
    opts = dict(device="cpu", seed=11, lut_graph=lut, randomize=False,
                native=False, fleet=True)
    entered = []
    real = sweeps.job_shards

    def job_shards(devices):
        entered.append(list(devices))
        return real(devices)

    monkeypatch.setattr(sweeps, "job_shards", job_shards)
    res, stats = [], []
    for plan in (None, _plan([CPU] * 4)):
        ctx = SearchContext(Options(**opts), fleet_plan=plan)
        res.append(_sig(search_boxes_one_output(
            ctx, tfleet.toy_fleet_boxes(), 0, save_dir=None,
            log=lambda s: None)))
        stats.append({k: ctx.stats[k] for k in (
            "device_dispatches", "fleet_dispatches", "fleet_singletons",
            "fleet_lanes", "fleet_rounds", "fleet_submits")})
        if plan is None:
            assert entered == []
    assert res[0] == res[1]
    assert stats[0] == stats[1] and stats[0]["fleet_dispatches"] >= 1
    assert entered == [[CPU] * 4] * stats[1]["device_dispatches"]


@pytest.mark.parametrize("lut", [False, True])
def test_stacked_steps_on_four_job_shards_match_the_jax_package(lut, counts):
    """The stacked node heads of three jobs (a jobs bucket of 4 lanes,
    one per job shard) under a 4-job-shard plan in both packages; the
    LUT heads' K3 lane form launched by the shard of the one job that
    reaches the 5-LUT sweep, once per ``done``."""
    jctx = JContext(
        JOptions(seed=3, lut_graph=lut, host_small_steps=False,
                 native_engine=False),
        fleet_plan=JFleetPlan(jmake_fleet_mesh(jax.devices()[:4])))
    tctx = SearchContext(Options(device="cpu", seed=3, lut_graph=lut,
                                 native=False),
                         fleet_plan=_plan([CPU] * 4))
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
    assert counts == ({K3L: {2: 2}} if lut else {})
