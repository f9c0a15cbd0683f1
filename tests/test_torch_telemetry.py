"""The port's telemetry: tracer, metrics registry, heartbeat, flight
recorder, attribution and the guards, on the CPU.

Port counterparts of the JAX package's tests/test_telemetry.py (the tracer
across threads, the Perfetto schema, registry atomicity and parity,
histogram quantiles, heartbeat resume, the flight ring's bound and its
triggers, attribution rows), plus what is the port's own: the registry held
against the JAX package's on the same seeded observations, the analytic
kernel costs held against the formulas ``chip_smoke.py`` used before they
moved into ``telemetry/attribution.py``, the per-launch timing and its
deadline gate, the sync guard, and a SIGTERM'd CLI run's artifacts.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from sboxgates_tpu.telemetry import metrics as jmetrics
from sboxgates_tpu_torch.telemetry import attribution as tattr
from sboxgates_tpu_torch.telemetry import flight as tflight
from sboxgates_tpu_torch.telemetry import metrics as tmetrics
from sboxgates_tpu_torch.telemetry import trace as ttrace
from sboxgates_tpu_torch.telemetry.heartbeat import Heartbeat

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
FA = os.path.join(DATA, "crypto1_fa.txt")
DES = os.path.join(DATA, "des_s1.txt")


@pytest.fixture(autouse=True)
def _clean_telemetry_state():
    """Every test starts from, and leaves, a quiet process tracer, flight
    recorder and attribution store (all process-global by design)."""
    tr, fr = ttrace.tracer(), tflight.flight_recorder()

    def quiet():
        tr.enabled = False
        tr.reset()
        fr.reset()
        fr.configure(None)
        fr.clear_hooks()
        ttrace.set_rank(None)
        tattr.reset()

    quiet()
    yield
    quiet()


def _state(g, seed=0):
    from sboxgates_tpu_torch.core import boolfunc as bf
    from sboxgates_tpu_torch.graph.state import GATES, State

    rng = np.random.default_rng(seed)
    st = State.init_inputs(8)
    while st.num_gates < g:
        a, b = rng.choice(st.num_gates, size=2, replace=False)
        st.add_gate(bf.XOR, int(a), int(b), GATES)
    return st


# -- tracer ------------------------------------------------------------------


def test_tracer_records_spans_across_threads():
    tr = ttrace.tracer()
    tr.enabled = True
    with ttrace.span("dispatch[x]", "dispatch", kernel="x") as sp:
        sp.set(launches=2)

    def worker():
        with ttrace.span("dispatch[y]", "dispatch", kernel="y"):
            pass

    t = threading.Thread(target=worker)
    t.start()
    t.join(10)
    assert not t.is_alive()
    evs = tr.events()
    assert {e[0] for e in evs} == {"dispatch[x]", "dispatch[y]"}
    assert len({e[4] for e in evs}) == 2  # one buffer per thread
    x = next(e for e in evs if e[0] == "dispatch[x]")
    assert x[5] == {"kernel": "x", "launches": 2}
    assert evs[0][2] <= evs[1][2] and all(e[3] >= 0 for e in evs)


def test_tracer_disabled_records_nothing_but_flight_ring():
    tr = ttrace.tracer()
    with ttrace.span("dispatch[x]", "dispatch"):
        pass
    ttrace.instant("mark", "journal")
    assert ttrace.span("phase", "phase", _flight=False) is ttrace.trace_null()
    assert tr.events() == []
    assert {e[0] for e in tflight.flight_recorder().events()} == {
        "dispatch[x]", "mark"}


def test_perfetto_export_schema(tmp_path):
    """Metadata plus X and i events, microsecond timestamps, monotone and
    non-negative, integer thread ids, pid = the process rank."""
    ttrace.set_rank(2)
    tr = ttrace.tracer()
    tr.enabled = True
    with ttrace.span("dispatch[k]", "dispatch", kernel="k", g=64):
        time.sleep(0.001)
    ttrace.instant("deadline.breach", "deadline", label="w")
    with ttrace.span("journal[iter_done]", "journal"):
        pass
    doc = json.load(open(tr.export(str(tmp_path / "trace.json"))))
    evs = doc["traceEvents"]
    assert any(e["ph"] == "M" and e["name"] == "process_name" for e in evs)
    rest = [e for e in evs if e["ph"] != "M"]
    assert {e["ph"] for e in rest} == {"X", "i"}
    last = -1.0
    for e in rest:
        assert set(e) >= {"name", "cat", "ts", "pid", "tid"}
        assert isinstance(e["tid"], int) and e["pid"] == 2
        assert e["ts"] >= max(last, 0.0)
        last = e["ts"]
        assert e["dur"] >= 0.0 if e["ph"] == "X" else e["s"] == "t"
    span = next(e for e in rest if e["name"] == "dispatch[k]")
    assert span["args"] == {"kernel": "k", "g": 64}


# -- metrics registry --------------------------------------------------------


def test_registry_increments_are_atomic_across_threads():
    r = tmetrics.context_registry()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def w():
            for _ in range(2000):
                r.inc("lut5_candidates")
                r.observe("device_wait_s[t]", 0.001)

        threads = [threading.Thread(target=w) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert r["lut5_candidates"] == 32000
    assert r.histograms()["device_wait_s[t]"]["count"] == 32000


def test_registry_reads_like_the_dict_it_replaced():
    r = tmetrics.context_registry()
    r.inc("pair_candidates", 7)
    assert r["pair_candidates"] == 7
    assert r.get("nope", 3) == 3
    # A declared counter never set reads 0 (the port's Stats did), and is
    # not listed.
    assert r["order_tier_dispatches"] == 0 and "order_tier_dispatches" not in r
    with pytest.raises(KeyError):
        r["nope"]
    assert "pair_candidates" in r and dict(r)["pair_candidates"] == 7
    snap = dict(r)
    r.inc("pair_candidates", 100)
    r.restore(snap)
    assert r["pair_candidates"] == 7
    f = r.fork()
    assert f["pair_candidates"] == 0
    f.inc("pair_candidates", 2)
    f.observe("device_wait_s[test]", 0.5)
    r.merge(f)
    assert r["pair_candidates"] == 9
    assert r.histograms()["device_wait_s[test]"]["count"] == 1


def test_registry_flags_undeclared_counters():
    r = tmetrics.context_registry()
    r.inc("device_dispatches")
    r.observe("dispatch_latency_s[pivot_window/8x256x512]", 0.1)
    assert r.undeclared() == set()
    r.inc("totally_unknown_counter")
    assert r.undeclared() == {"totally_unknown_counter"}


def test_declared_names_keep_the_jax_tables_kind_and_unit():
    shared = set(tmetrics.METRICS) & set(jmetrics.METRICS)
    assert shared == set(tmetrics.METRICS)
    for name in shared:
        assert tmetrics.METRICS[name].kind == jmetrics.METRICS[name].kind, name
        assert tmetrics.METRICS[name].unit == jmetrics.METRICS[name].unit, name
    assert set(tmetrics.CONTEXT_COUNTERS) <= set(jmetrics.CONTEXT_COUNTERS)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_matches_the_jax_registry(seed):
    """The same seeded increments and observations give both registries
    equal scalars and the same histogram snapshots (quantiles within
    1e-12)."""
    rng = np.random.default_rng(seed)
    regs = (tmetrics.MetricsRegistry(declared=None),
            jmetrics.MetricsRegistry(declared=None))
    names = ["a", "b", "c"]
    hists = ["h[x]", "h[y]"]
    for _ in range(500):
        if rng.random() < 0.5:
            k, by = names[rng.integers(3)], int(rng.integers(-3, 10))
            for r in regs:
                r.inc(k, by)
        else:
            k = hists[rng.integers(2)]
            v = float(10.0 ** rng.uniform(-5, 3))
            for r in regs:
                r.observe(k, v)
    assert regs[0].scalars() == regs[1].scalars()
    got, want = regs[0].histograms(), regs[1].histograms()
    assert set(got) == set(want)
    for k in want:
        assert got[k]["counts"] == want[k]["counts"]
        for q in ("p50", "p90", "p99", "mean", "min", "max"):
            assert abs(got[k][q] - want[k][q]) <= 1e-12, (k, q)


def test_histogram_buckets_and_stats():
    h = tmetrics.Histogram(bounds=(0.1, 1.0))
    for v in (0.05, 0.5, 0.5, 5.0):
        h.observe(v)
    assert h.counts == [1, 2, 1]
    snap = h.snapshot()
    assert snap["count"] == 4 and snap["min"] == 0.05 and snap["max"] == 5.0
    assert abs(snap["mean"] - 6.05 / 4) < 1e-12


@pytest.mark.parametrize("bounds,values,want", [
    # p50 rank 2 in (1, 2]: 1.5; p90 rank 3.6 in (2, 4]: 3.2, clamped to 3.0.
    ((1.0, 2.0, 4.0), (0.5, 1.5, 1.5, 3.0), (1.5, 3.0, 3.0)),
    # One interior bucket: interpolation inside it, clamped to the range.
    ((1.0, 2.0), (1.2, 1.4, 1.6, 1.8), (1.5, None, 1.8)),
    # A single observation: every quantile is that observation.
    ((10.0,), (3.0,), (3.0, 3.0, 3.0)),
    # Ranks in the overflow bucket return the observed max.
    ((1.0,), (0.5, 5.0, 9.0), (9.0, None, 9.0)),
])
def test_histogram_quantiles(bounds, values, want):
    h = tmetrics.Histogram(bounds=bounds)
    for v in values:
        h.observe(v)
    for q, w in zip((0.5, 0.9, 0.99), want):
        if w is not None:
            assert h.quantile(q) == pytest.approx(w)
    h0 = tmetrics.Histogram()
    assert h0.quantile(0.5) != h0.quantile(0.5)  # NaN
    assert "p50" not in h0.snapshot()


def test_bump_accepts_dicts_and_registries():
    d = {}
    tmetrics.bump(d, "x", 2)
    tmetrics.bump(d, "x")
    assert d == {"x": 3}
    r = tmetrics.MetricsRegistry(declared=None)
    tmetrics.bump(r, "x", 5)
    assert r["x"] == 5
    tmetrics.bump(None, "x")


# -- registry parity and dispatch spans on real searches ---------------------


def test_registry_parity_native_search():
    from sboxgates_tpu_torch.graph.state import State
    from sboxgates_tpu_torch.search import (
        Options,
        SearchContext,
        generate_graph_one_output,
        make_targets,
    )
    from sboxgates_tpu_torch.utils.sbox import load_sbox

    sbox, n = load_sbox(FA)
    ctx = SearchContext(Options(seed=3, device="cpu"))
    generate_graph_one_output(ctx, State.init_inputs(n), make_targets(sbox), 0,
                              save_dir=None, log=lambda s: None)
    assert ctx.stats["engine_nodes"] > 0
    assert ctx.stats.undeclared() == set()
    assert ctx.prof.snapshot()["gate_engine_native"][1] >= 1


def _device_lut_search(trace_on):
    """A device-route LUT head and 5-LUT search on a G = 24 state against
    an unrealizable target (whole sweeps), K3 on the 5-LUT chunks."""
    from sboxgates_tpu_torch.core import ttable as tt
    from sboxgates_tpu_torch.search import Options, SearchContext
    from sboxgates_tpu_torch.search import lut as slut

    ctx = SearchContext(Options(seed=5, lut_graph=True, randomize=False,
                                device="cpu", native=False, trace=trace_on))
    st = _state(24)
    target = np.zeros(8, dtype=np.uint32)
    mask = tt.mask_table(8)
    ctx.lut_step(st, target, mask, [])
    slut.lut5_search(ctx, st, target, mask, [])
    return ctx


def test_registry_parity_and_dispatch_spans_on_the_device_route():
    """Every device sweep is one dispatch span and one device_dispatches
    count; the K3 launches are timed (plain-version wall on the CPU) and
    attributed; nothing undeclared is counted."""
    ctx = _device_lut_search(True)
    spans = [e for e in ttrace.tracer().events() if e[1] == "dispatch"]
    assert ctx.stats["device_dispatches"] >= 2
    assert len(spans) == ctx.stats["device_dispatches"]
    assert ctx.stats.undeclared() == set()
    hists = ctx.stats.histograms()
    k3 = {k: h["count"] for k, h in hists.items()
          if k.startswith("dispatch_latency_s[lut5_filter/")}
    assert k3 and all(c > 0 for c in k3.values())
    rows = [r for r in tattr.table(ctx.stats) if r["kernel"] == "lut5_filter"]
    assert {f"dispatch_latency_s[lut5_filter/{r['bucket']}]" for r in rows} == set(k3)
    assert all(r["dispatches"] == k3[f"dispatch_latency_s[lut5_filter/{r['bucket']}]"]
               for r in rows)
    launched = [e for e in spans if e[5] and e[5].get("launches")]
    assert launched and all(e[5]["ops"] > 0 for e in launched)


def test_telemetry_adds_zero_host_syncs():
    """The syncs the CPU sync guard counts (.item, .cpu, .tolist, .numpy,
    synchronize) are the same with the tracer on and off."""
    from sboxgates_tpu_torch.utils.guards import sync_guard

    counts = []
    for on in (False, True):
        with sync_guard(action="count") as rep:
            _device_lut_search(on)
        ttrace.tracer().enabled = False
        counts.append(rep.syncs)
    assert counts[0] == counts[1] > 0


def test_sync_guard_raises_past_its_allowance_and_restores_the_methods():
    from sboxgates_tpu_torch.utils.guards import SyncError, sync_guard

    real = torch.Tensor.item
    t = torch.ones(3)
    reached = []
    with pytest.raises(SyncError, match="host sync #2"):
        with sync_guard(allowed=1):
            t.sum().item()
            t.tolist()
            reached.append(1)
    assert not reached
    with sync_guard(allowed=0, action="count") as rep:
        np.asarray(t)
        t.cpu()
        torch.cuda.synchronize
    assert rep.syncs == 2
    assert torch.Tensor.item is real and "item" not in torch.Tensor.__dict__


def test_recompile_guard_counts_builds_in_the_block():
    from sboxgates_tpu_torch import _kernels, native
    from sboxgates_tpu_torch.utils.guards import RecompileError, recompile_guard

    with recompile_guard(allowed=0) as rep:
        pass
    assert rep.compiles == 0
    before = native.compiles
    try:
        with pytest.raises(RecompileError):
            with recompile_guard(allowed=0, label="unit"):
                native.compiles += 1
        with recompile_guard(allowed=2) as rep:
            _kernels.compiles += 1
            native.compiles += 1
        assert rep.compiles == 2
    finally:
        native.compiles = before
        _kernels.compiles -= 1


# -- per-launch timing -------------------------------------------------------


def _window_operands(n=2):
    from sboxgates_tpu_torch.search.lut import PivotOperands
    from sboxgates_tpu_torch.ops import sweeps

    st = _state(20, 3)
    tables = sweeps.as_words(np.pad(st.live_tables(), ((0, 44), (0, 0))), "cpu")
    rng = np.random.default_rng(1)
    target = rng.integers(0, 2**32, size=8, dtype=np.uint64).astype(np.uint32)
    ops = PivotOperands(20, 16, 32, [], tables, target,
                        np.full(8, 0xFFFFFFFF, np.uint32), "cpu")
    descs = torch.from_numpy(ops.descs)
    return (*ops.stream_args()[:6], descs, 0, n, ops.t_real, 16, 32)


def test_launches_are_timed_only_inside_a_recording_and_gated():
    from sboxgates_tpu_torch.ops import pivot_tile
    from sboxgates_tpu_torch.resilience.deadline import Attempt

    args = _window_operands()
    reg = tmetrics.context_registry()
    timer = tattr.LaunchTimer(reg)
    pivot_tile.pivot_window(*args)  # no recording: nothing observed
    assert reg.histograms() == {}
    with tattr.recording(timer) as launched:
        pivot_tile.pivot_window(*args)
    key = "dispatch_latency_s[pivot_window/2x16x32]"
    assert launched == [("pivot_window", "2x16x32")]
    assert reg.histograms()[key]["count"] == 1
    gate = Attempt()
    gate.abandon()
    with tattr.recording(timer, gate):
        pivot_tile.pivot_window(*args)
    assert reg.histograms()[key]["count"] == 1  # abandoned: not recorded
    (row,) = tattr.table(reg)
    cost = tattr.window_cost(2, 16, 32, "packed")
    assert row["ops"] == cost["ops"] and row["tc_ops"] == cost["tc_ops"]
    assert timer.drain(timeout_s=0.1) == 0


def test_launch_hands_no_events_off_the_card():
    """The event handles a wrapper passes to its kernel's entry point are
    null unless a recording times a CUDA launch."""
    reg = tmetrics.context_registry()
    like = torch.zeros(1)
    with tattr.launch("k", "b", lambda: {"bytes": 1, "ops": 1}, like) as ev:
        assert ev == tattr.NO_EVENTS == (None, None)
    with tattr.recording(tattr.LaunchTimer(reg)):
        with tattr.launch("k", "b", lambda: {"bytes": 1, "ops": 1}, like) as ev:
            assert ev == tattr.NO_EVENTS
    assert reg.histograms()["dispatch_latency_s[k/b]"]["count"] == 1
    with pytest.raises(RuntimeError):
        with tattr.recording(tattr.LaunchTimer(reg)):
            with tattr.launch("k", "b", lambda: {"bytes": 1, "ops": 1}, like):
                raise RuntimeError("refused launch")
    assert reg.histograms()["dispatch_latency_s[k/b]"]["count"] == 1


def test_each_context_starts_an_empty_cost_store():
    """A run's attribution holds its own launches only, drawn against its
    own device's peaks: a new context empties the process's cost store."""
    from sboxgates_tpu_torch.search import Options, SearchContext

    tattr.note_backend("cuda")
    assert tattr.capture("k_old", {"bytes": 1e3, "ops": 1.0}, bucket="a")
    ctx = SearchContext(Options(seed=1, device="cpu"))
    snap = tattr.snapshot(ctx.stats)
    assert snap["rows"] == [] and snap["backend"] == "cpu"
    assert snap["timing"] == tattr.TIMING["cpu"]


# -- analytic costs ------------------------------------------------------------

# The formulas chip_smoke.py computed before they moved into the attribution
# module, verbatim.
_WALSH_THREADS = 512


def _old_window_cost(n, tl, th, backend):
    cand = tl * th
    row = 32 if backend == "packed" else 256
    per_tile_in = 20 + 32 + tl * 2 * 4 * row + th * 4 * row + tl + th
    return {"bytes": n * (per_tile_in + 9 * cand + 4),
            "ops": n * cand * (576 + 4),
            "tc_ops": n * 2 * 2 * (8 * tl) * (4 * th) * 256}


def _old_walsh_cost(b, sms):
    blocks = min((b + _WALSH_THREADS - 1) // _WALSH_THREADS, 2 * sms)
    return {"bytes": b * (32 + 4) + 256 * 4,
            "ops": blocks * (8 * 256 + 8192) + b * 64}


def _old_bound(r, b1_ops_per_s=None):
    t_bytes = r["bytes"] / 3.35e12 * 1e3
    forms = [(r["ops"] / (64 * 132 * 1.98e9) * 1e3, "integer pipe")]
    if "tc_ops" in r:
        forms.append((r["tc_ops"] / 1.979e15 * 1e3, "int8 tensor cores"))
        if b1_ops_per_s:
            forms.append((r["tc_ops"] / b1_ops_per_s * 1e3, "1-bit tensor cores"))
    t_ops, form = min(forms)
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", form)


#: The H100 peaks without the measured 1-bit rate: the data-sheet peaks
#: chip_smoke.py's formulas were written against.
_DATA_SHEET = {k: v for k, v in tattr.PEAKS["gpu"].items() if k != "b1_tc_ops_per_s"}


@pytest.mark.parametrize("n", [1, 64])
@pytest.mark.parametrize("shape", [(256, 512), (512, 512)])
@pytest.mark.parametrize("backend", ["packed", "pre"])
def test_window_costs_equal_chip_smokes_formulas(n, shape, backend):
    got = tattr.window_cost(n, *shape, backend)
    assert got == _old_window_cost(n, *shape, backend)
    assert tattr.bound(got, _DATA_SHEET) == _old_bound(got)
    assert tattr.bound(got) == _old_bound(got, tattr.PEAKS["gpu"]["b1_tc_ops_per_s"])


@pytest.mark.parametrize("form", ["integer pipe", "int8 tensor cores",
                                  "1-bit tensor cores"])
def test_bound_takes_the_smallest_of_three_forms(form):
    """The same work counted three ways (32-bit logic, int8 and 1-bit
    tensor-core operations): the fastest form sets the bound."""
    key = {"integer pipe": "int32_ops_per_s",
           "int8 tensor cores": "int8_tc_ops_per_s",
           "1-bit tensor cores": "b1_tc_ops_per_s"}[form]
    pk = {"bytes_per_s": 1e12, "int32_ops_per_s": 1e9,
          "int8_tc_ops_per_s": 2e9, "b1_tc_ops_per_s": 4e9}
    pk[key] = 1e12
    cost = {"bytes": 1.0, "ops": 3e9, "tc_ops": 6e9}
    ms, by, got = tattr.bound(cost, pk)
    assert got == form and by == "operations"
    want = {"integer pipe": 3e9, "int8 tensor cores": 6e9,
            "1-bit tensor cores": 6e9}[form] / 1e12 * 1e3
    assert ms == pytest.approx(want)
    # Bytes still win when they take longer than every form.
    assert tattr.bound({**cost, "bytes": 1e13}, pk)[:2] == (1e4, "bytes")


@pytest.mark.parametrize("n,slots", [(48, 64), (52, 64), (1, 1)])
def test_bound_without_the_1bit_peak_is_todays(n, slots):
    """A peaks row without ``b1_tc_ops_per_s`` (the CPU's, or the H100's
    data-sheet rates alone) bounds K1's lane form as before the 1-bit
    form; with the H100's measured 1-bit rate the form is taken, and at
    the lane form's shapes the bytes then bound it."""
    cost = tattr.window_lanes_cost(n, slots, 256, 512)
    assert "b1_tc_ops_per_s" not in tattr.PEAKS["cpu"]
    assert tattr.bound(cost, _DATA_SHEET) == _old_bound(cost)
    assert tattr.bound(cost, _DATA_SHEET)[2] == "int8 tensor cores"
    cpu = tattr.PEAKS["cpu"]
    t_ops = min(cost["ops"] / cpu["int32_ops_per_s"],
                cost["tc_ops"] / cpu["int8_tc_ops_per_s"]) * 1e3
    assert tattr.bound(cost, cpu)[0] == max(cost["bytes"] / cpu["bytes_per_s"] * 1e3,
                                            t_ops)
    ms, by, form = tattr.bound(cost)
    assert form == "1-bit tensor cores" and by == "bytes"
    assert ms == cost["bytes"] / 3.35e12 * 1e3 < tattr.bound(cost, _DATA_SHEET)[0]


@pytest.mark.parametrize("b", [64, 512, 1 << 20])
def test_walsh_costs_equal_chip_smokes_formulas(b):
    got = tattr.walsh_cost(b, 132)
    assert got == _old_walsh_cost(b, 132)
    assert tattr.bound(got) == _old_bound(got)


@pytest.mark.parametrize("n,b", [(1 << 17, 64), (1 << 17, 512), (1024, 64)])
def test_filter_costs_equal_chip_smokes_formulas(n, b):
    got = tattr.filter_cost(n, b)
    assert got == {"bytes": n * 5 * 4 + b * 8 * 4 + 2 * 8 * 4 + 2 * n * 4,
                   "ops": n * ((62 + 64) * 8 + 64)}
    if (n, b) == (1 << 17, 64):
        # PERF.md's K3 bound: 0.00840 ms by operations.
        ms, by, _ = tattr.bound(got)
        assert round(ms, 5) == 0.0084 and by == "operations"


@pytest.mark.parametrize("name", ["des_s1_bit0_lut_best", "des_s1_bit0_17gates"])
def test_circuit_costs_equal_chip_smokes_formula(name):
    from sboxgates_tpu_torch.codegen import cuda_kernel, output_bits
    from sboxgates_tpu_torch.graph.xmlio import load_state

    st = load_state(os.path.join(ROOT, "examples", name + ".xml"))
    w = 1 << 22
    n_out = len(output_bits(st))
    prog, _, _ = cuda_kernel.pack_program(st)
    got = tattr.circuit_cost(st.num_inputs, n_out, len(prog), w)
    assert got == {"bytes": 4 * (st.num_inputs + n_out) * w + 16 * len(prog),
                   "ops": len(prog) * w}


def test_attribution_rows_placement_and_utilization():
    tattr.note_backend("cuda")
    pk = tattr.peaks()
    assert pk["backend"] == "gpu" and pk["bytes_per_s"] == 3.35e12
    mem = {"bytes": 3.35e9, "ops": 1e3}            # 1 ms of HBM
    ops = {"bytes": 1e3, "ops": pk["int32_ops_per_s"] * 1e-3}  # 1 ms of LOP3
    assert tattr.capture("k_hbm", mem, bucket="a")
    assert tattr.capture("k_alu", ops, bucket="b")
    assert tattr.have("k_hbm", "a") and not tattr.have("k_hbm", "b")
    reg = tmetrics.MetricsRegistry(declared=None)
    for _ in range(4):
        reg.observe("dispatch_latency_s[k_hbm/a]", 2e-3)
        reg.observe("dispatch_latency_s[k_alu/b]", 1e-3)
    rows = {r["kernel"]: r for r in tattr.table(reg)}
    assert rows["k_hbm"]["roofline"] == "memory-bound"
    assert rows["k_alu"]["roofline"] == "compute-bound"
    assert rows["k_hbm"]["dispatches"] == 4
    assert rows["k_hbm"]["roofline_utilization"] == pytest.approx(0.5)
    assert rows["k_alu"]["roofline_utilization"] == pytest.approx(1.0)
    assert tattr.annotation("k_alu", "b") == {"ops": ops["ops"], "bytes": 1e3}
    reg.observe("dispatch_latency_s[k_alu/c]", 1.0)
    tattr.capture("k_alu", ops, bucket="c")
    assert {r["bucket"]: r.get("roofline") for r in tattr.table(reg)
            if r["kernel"] == "k_alu"}["c"] == "dispatch-bound"


def test_attribution_capture_never_raises():
    assert tattr.capture("k_bad", None) is False
    assert tattr.capture("k_zero", {"bytes": 0, "ops": 0}) is False
    assert tattr.table(None) == []


# -- heartbeat -----------------------------------------------------------------


def test_heartbeat_lines_and_atomic_snapshot(tmp_path):
    r = tmetrics.context_registry()
    r.inc("device_dispatches", 5)
    hb = Heartbeat(r, str(tmp_path), interval_s=0.05, rank=1).start()
    time.sleep(0.25)
    snap_path = hb.stop()
    lines = [json.loads(ln) for ln in open(tmp_path / "telemetry.jsonl")]
    assert lines[0]["kind"] == "start" and lines[-1]["kind"] == "final"
    assert len(lines) >= 3
    for ln in lines:
        assert ln["rank"] == 1 and ln["counters"]["device_dispatches"] == 5
        assert "process" in ln and "uptime_s" in ln
    snap = json.load(open(snap_path))
    assert snap["counters"]["device_dispatches"] == 5
    assert "histograms" in snap and "attribution" in snap and snap["rank"] == 1
    assert sorted(os.listdir(tmp_path)) == ["metrics.json", "telemetry.jsonl"]


def test_heartbeat_resume_appends(tmp_path):
    r = tmetrics.MetricsRegistry(declared=None)
    Heartbeat(r, str(tmp_path), interval_s=0).start().stop(snapshot=False)
    n1 = len(open(tmp_path / "telemetry.jsonl").readlines())
    Heartbeat(r, str(tmp_path), interval_s=0, resume=True).start().stop(
        snapshot=False)
    n2 = len(open(tmp_path / "telemetry.jsonl").readlines())
    assert n2 == 2 * n1 == 4
    Heartbeat(r, str(tmp_path), interval_s=0).start().stop(snapshot=False)
    assert len(open(tmp_path / "telemetry.jsonl").readlines()) == 2


# -- flight recorder -------------------------------------------------------------


def test_flight_dump_on_deadline_exhaustion(tmp_path):
    from sboxgates_tpu_torch.resilience import faults
    from sboxgates_tpu_torch.resilience.deadline import (
        DeadlineConfig,
        DispatchTimeout,
        dispatch_with_retry,
    )

    tflight.configure(str(tmp_path))
    stats = tmetrics.context_registry()
    faults.disarm()
    faults.arm("dispatch.sweep", "hang")
    try:
        with pytest.raises(DispatchTimeout):
            dispatch_with_retry(
                lambda: None,
                DeadlineConfig(budget_s=0.05, retries=1, backoff_s=0.01),
                stats=stats, label="lut5.pivot.test",
            )
    finally:
        faults.disarm()
    (dump,) = sorted(tmp_path.glob("flight-rank00-*.json"))
    assert dump.stat().st_size <= tflight.DUMP_MAX_BYTES + 4096
    doc = json.load(open(dump))
    assert doc["reason"] == "deadline_exhausted"
    assert doc["extra"]["label"] == "lut5.pivot.test"
    names = [e["name"] for e in doc["events"]]
    assert "deadline.exhausted" in names and names.count("deadline.breach") == 2
    assert names.count("deadline.window") == 2
    assert doc["counters"]["deadline_breaches"] == 2
    assert stats["flight_dumps"] == 1


def test_flight_dump_bounded_under_flood(tmp_path):
    fr = tflight.flight_recorder()
    fr.configure(str(tmp_path))
    for i in range(20000):
        fr.note(f"e{i}", "dispatch", float(i), 0.001, {"x": "y" * 50})
    path = fr.dump("flood_test")
    assert os.path.getsize(path) <= tflight.DUMP_MAX_BYTES + 4096
    assert len(json.load(open(path))["events"]) <= tflight.RING_CAP
    fr.configure(None)
    assert tflight.flight_dump("nowhere") is None


def test_rank_is_zero_whatever_the_environment_says(tmp_path, monkeypatch):
    """The port is one process at rank 0: a ``RANK`` variable left in the
    environment changes neither the dump's name nor the trace's pid."""
    monkeypatch.setenv("RANK", "5")
    tflight.configure(str(tmp_path))
    path = tflight.flight_dump("env_rank")
    assert os.path.basename(path) == "flight-rank00-1.json"
    assert json.load(open(path))["rank"] == 0
    tr = ttrace.tracer()
    tr.enabled = True
    ttrace.instant("mark", "journal")
    doc = json.load(open(tr.export(str(tmp_path / "trace.json"))))
    assert {e["pid"] for e in doc["traceEvents"]} == {0}


def test_circuit_breaker_trip_dumps(tmp_path):
    from sboxgates_tpu_torch.search import Options, SearchContext

    tflight.configure(str(tmp_path))
    ctx = SearchContext(Options(seed=1, device="cpu"))
    ctx.trip_device_breaker()
    assert ctx.device_degraded and ctx.stats["circuit_breaker_trips"] == 1
    (dump,) = tmp_path.glob("flight-rank00-*.json")
    assert json.load(open(dump))["reason"] == "circuit_breaker"
    assert ctx.stats["flight_dumps"] == 1


def test_journal_append_emits_span_and_counts(tmp_path):
    from sboxgates_tpu_torch.resilience.journal import SearchJournal

    tr = ttrace.tracer()
    tr.enabled = True
    before = tmetrics.GLOBAL.get("journal_appends", 0)
    j = SearchJournal.start(str(tmp_path), config={"seed": 1})
    j.append("iter_done", it=0)
    names = [e[0] for e in tr.events() if e[1] == "journal"]
    assert names == ["journal[run_start]", "journal[iter_done]"]
    assert tmetrics.GLOBAL["journal_appends"] == before + 2


def test_native_service_failure_is_counted_and_traced():
    from sboxgates_tpu_torch import native

    tr = ttrace.tracer()
    tr.enabled = True
    before = tmetrics.GLOBAL.get("native_service_failures", 0)
    native._note_service_failure(RuntimeError("boom"))
    assert tmetrics.GLOBAL["native_service_failures"] == before + 1
    (ev,) = [e for e in tr.events() if e[0] == "native.service_failure"]
    assert ev[1] == "fallback" and "boom" in ev[5]["error"]


def test_fatal_exception_dumps_and_closes_the_heartbeat(tmp_path, capsys):
    from sboxgates_tpu_torch import cli
    from sboxgates_tpu_torch.resilience import faults

    faults.disarm()
    faults.arm("ckpt.write", "raise", "1")
    try:
        with pytest.raises(faults.InjectedFault):
            cli.main(["-o", "0", "--seed", "1", "--device", "cpu",
                      "--output-dir", str(tmp_path), FA])
    finally:
        faults.disarm()
    (dump,) = tmp_path.glob("flight-rank00-*.json")
    assert json.load(open(dump))["reason"] == "fatal_exception"
    kinds = [json.loads(ln)["kind"] for ln in open(tmp_path / "telemetry.jsonl")]
    assert kinds == ["start", "incident:fatal_exception", "final"]
    assert (tmp_path / "metrics.json").exists()
    # The process-global recorder is cleared for the next run.
    assert tflight.flight_recorder().directory is None


_CRASH_ENV = {"SBG_FAULTS": "ckpt.write:crash"}


def test_injected_crash_leaves_a_dump_and_an_incident_line(tmp_path):
    """The crash fault action dumps the flight recorder before its exit,
    and the dump's incident hook writes the heartbeat's last line."""
    from sboxgates_tpu_torch.resilience.faults import CRASH_EXIT_CODE

    out = tmp_path / "run"
    env = dict(os.environ, PYTHONPATH=ROOT, **_CRASH_ENV)
    proc = subprocess.run(
        [sys.executable, "-m", "sboxgates_tpu_torch", FA, "--seed", "7", "-o",
         "0", "--device", "cpu", "--output-dir", str(out),
         "--metrics-interval", "300"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == CRASH_EXIT_CODE, proc.stderr
    (dump,) = out.glob("flight-rank00-*.json")
    doc = json.load(open(dump))
    assert doc["reason"] == "injected_crash" and doc["extra"]["site"] == "ckpt.write"
    assert any(e["cat"] == "journal" for e in doc["events"])
    kinds = [json.loads(ln)["kind"] for ln in open(out / "telemetry.jsonl")]
    assert kinds[0] == "start" and kinds[-1] == "incident:injected_crash"


def test_sigterm_leaves_a_dump_a_final_line_and_metrics(tmp_path):
    """SIGTERM mid-search: the worker thread dumps, tears down (final
    heartbeat line, metrics.json, trace) and the process dies by the
    signal."""
    out = tmp_path / "run"
    env = dict(os.environ, PYTHONPATH=ROOT, SBG_DISABLE_NATIVE="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "sboxgates_tpu_torch", DES, "-o", "0", "--seed",
         "1", "--device", "cpu", "--output-dir", str(out), "--trace",
         "--metrics-interval", "0.05"],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
    )
    try:
        deadline = time.monotonic() + 120
        hb = out / "telemetry.jsonl"
        while time.monotonic() < deadline and proc.poll() is None:
            if hb.exists() and len(hb.read_text().splitlines()) >= 3:
                break
            time.sleep(0.05)
        assert proc.poll() is None, proc.stderr.read()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert rc == -signal.SIGTERM
    (dump,) = out.glob("flight-rank00-*.json")
    doc = json.load(open(dump))
    assert doc["reason"] == "signal:SIGTERM"
    kinds = [json.loads(ln)["kind"] for ln in open(hb)]
    assert kinds[0] == "start" and kinds[-1] == "final"
    assert "incident:signal:SIGTERM" in kinds
    snap = json.load(open(out / "metrics.json"))
    assert snap["counters"]["flight_dumps"] == 1
    assert snap["counters"]["device_dispatches"] > 0
    json.load(open(out / "trace.json"))
