"""The fleet's candidate axis: each job shard's lane-form launches cut
along the candidates over its C candidate shards (``ops/sweeps.py:
job_shards`` with ``candidates``, entered by ``search/fleet.py:
call_lanes`` under a ``parallel/mesh.py: FleetPlan`` of C > 1).

- The CLI on 4 job shards x 2 candidate shards (``SBG_LOCAL_SHARDS=8
  --fleet-candidates 2``, device route) against the JAX CLI's files at 8
  devices (goldens of ``tests/torch_mesh_goldens.py``): the G = 99
  resume's 8 restarts (K1's lane form) and, marked slow, the DES-8 fleet
  (K3's lane form; the default run of ``chip_smoke.py`` holds it on the
  card, phase 14h), every (job shard, candidate shard) launching.
- The candidate-piece layout: ranges divisible by C, ragged, and narrower
  than C (empty pieces are not launched).
- K3's and K1's split against the unsplit call: the same outputs in lane
  and candidate order, the same host syncs, and one launch per (job
  shard, candidate shard) that owns work, under its device.
- A plan of one job shard x 2 candidates is split; a plan of C = 1
  launches exactly as the job shards alone do.
- A candidate shard's launch that raises: the call raises, and nothing
  runs again.
- The stacked steps under a (4, 2) plan against the JAX package's under
  ``make_fleet_mesh(devices, candidates=2)``.

Tolerance: exact equality (integer verdicts, file bytes).
"""

import contextlib
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
from sboxgates_tpu_torch.utils.guards import sync_guard

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mesh_goldens as mg  # noqa: E402
from test_torch_batched import _pivot_rows  # noqa: E402
from test_torch_fleet import _compare, _grow_both  # noqa: E402
from test_torch_fleet_shards import _lut5_rows  # noqa: E402
from torch_cli_helpers import environ  # noqa: E402

CPU = torch.device("cpu")
K3L, K1L = "lut5_filter_lanes", "pivot_window_lanes"
CLI_THREADS = 4
#: Local shard j * C + c is cpu:(j * C + c) in the placed tests.
DEVICES = [torch.device("cpu", i) for i in range(8)]


def _plan(devices, candidates=1):
    return tmesh.FleetPlan(tmesh.make_fleet_mesh(devices, candidates))


def _split(plan):
    """The job_shards arguments of a plan, as call_lanes gives them."""
    return plan.job_devices, plan.candidate_devices


@pytest.fixture
def counts():
    """The lane-form launches by job shard and by local shard, zeroed for
    the test."""
    for c in (sweeps.JOB_SHARD_LAUNCHES, sweeps.CANDIDATE_SHARD_LAUNCHES):
        c.clear()
    yield sweeps.JOB_SHARD_LAUNCHES, sweeps.CANDIDATE_SHARD_LAUNCHES
    for c in (sweeps.JOB_SHARD_LAUNCHES, sweeps.CANDIDATE_SHARD_LAUNCHES):
        c.clear()


# -- the CLI on 4 job shards x 2 candidate shards -----------------------------


@pytest.mark.parametrize("case,kernel", [
    pytest.param("fleet_des8_c2_d8_dev", K3L, marks=pytest.mark.slow),
    ("fleet_g99_i8_c2_d8_dev", K1L),
])
def test_four_by_two_shards_write_the_jax_clis_files(case, kernel, counts,
                                                     tmp_path):
    """``--fleet --fleet-candidates 2`` on eight local shards writes the
    JAX CLI's files at 8 devices, byte for byte (XML and journals); every
    one of the 8 (job shard, candidate shard) pairs launched the lane
    form, and every launch was a candidate shard's."""
    argv, env, devices, procs = mg.CLI_CASES[case]
    assert (devices, procs) == (8, 1)
    d = str(tmp_path / case)
    threads = torch.get_num_threads()
    torch.set_num_threads(CLI_THREADS)
    try:
        with environ(dict(env, **{tmesh.LOCAL_SHARDS_ENV: str(devices)})):
            assert cli.main([*argv, "--device", "cpu", "--output-dir",
                             d]) == 0
    finally:
        torch.set_num_threads(threads)
    mg.compare_files(case, d)
    by_job, by_local = (c[kernel] for c in counts)
    assert sorted(by_local) == list(range(8)) and min(by_local.values()) >= 1
    assert sorted(by_job) == [0, 1, 2, 3]
    for j in range(4):
        assert by_job[j] == by_local[2 * j] + by_local[2 * j + 1]


# -- the candidate-piece layout -----------------------------------------------


@pytest.mark.parametrize("n,parts,want", [
    # divisible by C
    (8, 2, [(0, 0, 4), (1, 4, 8)]),
    (64, 4, [(0, 0, 16), (1, 16, 32), (2, 32, 48), (3, 48, 64)]),
    (5, 1, [(0, 0, 5)]),
    # ragged
    (7, 2, [(0, 0, 4), (1, 4, 7)]),
    (3, 2, [(0, 0, 2), (1, 2, 3)]),
    # ceil(5 / 4) = 2: the fourth piece would start at 6, and is empty
    (5, 4, [(0, 0, 2), (1, 2, 4), (2, 4, 5)]),
    # narrower than C: only the pieces that own a candidate
    (1, 2, [(0, 0, 1)]),
    (3, 4, [(0, 0, 1), (1, 1, 2), (2, 2, 3)]),
])
def test_candidate_pieces_are_contiguous_and_never_empty(n, parts, want):
    assert sweeps.candidate_pieces(n, parts) == want
    plan = _plan([torch.device("cuda", i) for i in range(2 * parts)], parts)
    assert plan.n_job_shards == 2 and plan.n_candidate_shards == parts
    assert plan.candidate_devices == [
        [torch.device("cuda", j * parts + c) for c in range(parts)]
        for j in range(2)]
    assert plan.job_devices == [ds[0] for ds in plan.candidate_devices]
    with sweeps.job_shards(*_split(plan)):
        for j in range(2):
            assert sweeps.candidate_blocks(j, n) == [
                (c, plan.candidate_devices[j][c], lo, hi)
                for c, lo, hi in want]


# -- the split against the unsplit call ---------------------------------------


@pytest.fixture
def placed(monkeypatch):
    """Local shard i's device is cpu:i, and every launch records its
    kernel, the device context it ran under, its lanes and its candidates
    (K3's 5-tuples, K1's window of tiles)."""
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
            width = a[1].shape[1] if _name == K3L else a[8]
            state["launches"].append((_name, state["current"], a[0].shape[0],
                                      width))
            return _real(*a, **k)

        monkeypatch.setattr(sweeps, name, launch)
    return state


def _k3_operands(lanes, n):
    """K3 lane-form operands: tables [lanes, 12, 8], 5-tuples [lanes, n, 5],
    target and mask [lanes, 8]."""
    rng = np.random.default_rng(5)

    def ints(lo, hi, shape):
        return torch.from_numpy(rng.integers(lo, hi, shape, dtype=np.int64)
                                .astype(np.int32))

    return (ints(-2**31, 2**31, (lanes, 12, 8)), ints(0, 12, (lanes, n, 5)),
            ints(-2**31, 2**31, (lanes, 8)),
            torch.full((lanes, 8), -1, dtype=torch.int32))


@pytest.mark.parametrize("rows,n,tuples", [
    (range(8), 8, 64),          # every lane, C | N
    (range(8), 8, 63),          # ragged N
    (range(3), 3, 1),           # N narrower than C
    ([0, 3, 6, 7], 8, 17),      # a round's live lanes, ragged N
])
def test_k3_lane_form_launches_once_per_candidate_shard(rows, n, tuples,
                                                        placed, counts):
    """K3's lane form on 4 job shards x 2 candidate shards: one launch per
    job shard and nonempty piece of the N 5-tuples, under its candidate
    shard's device, and the outputs those of the unsplit launch, in lane
    and candidate order."""
    ops = _k3_operands(len(rows), tuples)
    want = sweeps._filter5(*ops, True)
    placed["launches"].clear()
    plan = _plan(DEVICES, 2)
    with sweeps.job_shards(*_split(plan)):
        got = sweeps._filter5(*ops, True, rows, n)
        blocks = sweeps.job_blocks(rows, n)
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    expect = [(K3L, DEVICES[2 * j + c], hi - lo, b - a)
              for j, _, lo, hi in blocks
              for c, a, b in sweeps.candidate_pieces(tuples, 2)]
    assert placed["launches"] == expect
    by_job, by_local = counts
    pieces = len(sweeps.candidate_pieces(tuples, 2))
    assert by_job == {K3L: {j: pieces for j, _, _, _ in blocks}}
    assert by_local == {K3L: {2 * j + c: 1 for j, _, _, _ in blocks
                              for c in range(pieces)}}


def _pivot_full(lanes):
    """Pivot rows swept from their first tile to their last: ragged gate
    counts, planted hits on even lanes, misses on odd ones."""
    rng = np.random.default_rng(19)
    return _pivot_rows(rng, (12, 13, 12, 14, 12, 12, 13, 12)[:lanes], 16, 16)


@pytest.mark.parametrize("cap", [16, 24])
def test_k1_lane_form_launches_once_per_candidate_shard_per_window(
        cap, placed, counts, monkeypatch):
    """K1's lane form on 4 job shards x 2 candidate shards: each window of
    w tiles one launch per job shard and nonempty piece of the w tiles
    (the first window, of 1 tile, on candidate shard 0 alone; at cap 24 a
    window of 3 tiles per lane as 2 + 1), under its device; the verdicts
    the unsplit call's."""
    monkeypatch.setattr(sweeps, "PIVOT_WINDOW_TILES", cap)
    rows = _pivot_full(8)
    statics = {"tl": 16, "th": 16}
    want = sweeps.lut5_pivot_stream_lanes(rows, **statics)
    widths = [w for _, _, _, w in placed["launches"]]
    placed["launches"].clear()
    with sweeps.job_shards(*_split(_plan(DEVICES, 2))):
        got = sweeps.lut5_pivot_stream_lanes(rows, **statics)
    np.testing.assert_array_equal(np.asarray(want), np.asarray(got))
    assert np.asarray(want)[:, 0].tolist().count(1) >= 2
    assert 1 in widths and max(widths) == cap // 8 and len(widths) >= 4
    assert placed["launches"] == [
        (K1L, DEVICES[2 * j + c], 2, b - a)
        for w in widths for j in range(4)
        for c, a, b in sweeps.candidate_pieces(w, 2)]
    wide = sum(w > 1 for w in widths)
    assert counts[1] == {K1L: {2 * j + c: len(widths) if c == 0 else wide
                               for j in range(4) for c in range(2)}}
    assert counts[0] == {K1L: {j: len(widths) + wide for j in range(4)}}


# (rows, lane form, statics, kernel, host syncs of one launch of the
# kernel's plain version: K1's lane form reads its descriptors to the
# host, a CPU copy that waits on no device)
LANE_FORMS = {
    "lut5_stream": (_lut5_rows, sweeps.lut5_stream_lanes, {"chunk": 1024},
                    K3L, 0),
    "lut5_pivot_stream": (_pivot_full, sweeps.lut5_pivot_stream_lanes,
                          {"tl": 16, "th": 16}, K1L, 1),
}


@pytest.mark.parametrize("name", sorted(LANE_FORMS))
def test_split_lane_forms_match_the_unsplit_call_with_its_syncs(name, counts,
                                                                placed):
    """Eight lanes on 4 x 2 shards: the unsplit call's verdicts, lane by
    lane, and its host syncs: the split adds none but the plain version's
    own, one per launch of it beyond the unsplit call's."""
    make, fn, statics, kernel, plain = LANE_FORMS[name]
    rows = make(8)
    with sync_guard(action="count") as rep:
        want = fn(rows, **statics)
    syncs, unsplit = rep.syncs, len(placed["launches"])
    with sync_guard(action="count") as rep, \
            sweeps.job_shards(*_split(_plan([CPU] * 8, 2))):
        got = fn(rows, **statics)
    assert len(got) == len(want) == 8
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    by = counts[1][kernel]
    assert sorted(by) == list(range(8))
    split = sum(by.values())
    assert split == len(placed["launches"]) - unsplit > unsplit
    assert rep.syncs == syncs + plain * (split - unsplit)


def test_one_job_shard_with_two_candidates_is_split(counts, placed):
    """A 1 x 2 plan (``--fleet-candidates 2`` on two shards): call_lanes
    splits the call, each K3 launch cut in two, one piece per candidate
    shard, and the verdicts the unsplit call's."""
    plan = _plan(DEVICES[:2], 2)
    assert (plan.n_job_shards, plan.n_candidate_shards) == (1, 2)
    rows = _lut5_rows(4)
    want = sweeps.lut5_stream_lanes(rows, chunk=1024)
    unsplit = list(placed["launches"])
    placed["launches"].clear()
    got = tfleet.call_lanes(plan, sweeps.lut5_stream_lanes, rows,
                            {"chunk": 1024})
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert placed["launches"] == [
        (K3L, DEVICES[c], 4, b - a) for _, _, _, n in unsplit
        for c, a, b in sweeps.candidate_pieces(n, 2)]
    assert counts[1] == {K3L: {0: len(unsplit), 1: len(unsplit)}}
    assert sweeps.job_blocks(range(4), 4) is None


@pytest.mark.parametrize("lane_form", sorted(LANE_FORMS))
def test_one_candidate_shard_launches_as_the_job_shards_alone(lane_form,
                                                              counts, placed):
    """A plan of four job shards and C = 1: each launch of the unsplit
    call becomes one launch per job shard of its two lanes, over all its
    candidates, on the job shard's device, as without a candidate axis;
    the local shard of (j, 0) is j."""
    make, fn, statics, kernel, _ = LANE_FORMS[lane_form]
    rows = make(8)
    want = fn(rows, **statics)
    unsplit = list(placed["launches"])
    placed["launches"].clear()
    got = tfleet.call_lanes(_plan(DEVICES[:4]), fn, rows, statics)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert placed["launches"] == [(kernel, DEVICES[j], 2, w)
                                  for _, _, _, w in unsplit for j in range(4)]
    by_job, by_local = counts
    assert by_local == by_job == {kernel: {j: len(unsplit) for j in range(4)}}


def test_a_failing_candidate_launch_raises_and_nothing_runs_again(
        placed, counts, monkeypatch):
    """Candidate shard 1 of job shard 1 (local shard 3) raises: the call
    raises; the three pieces launched before it are not launched again,
    and no other runs, on the first device or any other."""
    real = sweeps.lut5_filter_cells_lanes

    def launch(*a, **k):
        if placed["current"] == DEVICES[3]:
            raise RuntimeError("candidate shard 3 failed")
        return real(*a, **k)

    monkeypatch.setattr(sweeps, "lut5_filter_cells_lanes", launch)
    rows = _lut5_rows(8)
    with sweeps.job_shards(*_split(_plan(DEVICES, 2))), \
            pytest.raises(RuntimeError, match="candidate shard 3 failed"):
        sweeps.lut5_stream_lanes(rows, chunk=1024)
    assert [d for _, d, _, _ in placed["launches"]] == DEVICES[:3]
    assert counts == ({K3L: {0: 2, 1: 1}}, {K3L: {0: 1, 1: 1, 2: 1}})


# -- the stacked steps against the JAX package --------------------------------


@pytest.mark.parametrize("lut", [False, True])
def test_stacked_steps_on_four_by_two_shards_match_the_jax_package(lut,
                                                                   counts):
    """The stacked node heads of three jobs (a jobs bucket of 4 lanes, one
    per job shard) under a (4, 2) plan in both packages; the LUT heads'
    K3 lane form launched by both candidate shards of the job shard of the
    one job that reaches the 5-LUT sweep, once per ``done``."""
    jctx = JContext(
        JOptions(seed=3, lut_graph=lut, host_small_steps=False,
                 native_engine=False),
        fleet_plan=JFleetPlan(jmake_fleet_mesh(jax.devices()[:8],
                                               candidates=2)))
    tctx = SearchContext(Options(device="cpu", seed=3, lut_graph=lut,
                                 native=False),
                         fleet_plan=_plan([CPU] * 8, 2))
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
    assert counts == (({K3L: {2: 4}}, {K3L: {4: 2, 5: 2}}) if lut
                      else ({}, {}))
