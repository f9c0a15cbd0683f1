"""The port's serve orchestrator against the JAX package's.

The cases of the JAX package's tests/test_serve.py, on the port: the
reference of every job is the JAX package itself, either its serve run of
the same jobs (each job's XML and journal byte for byte) or the job run
standalone on a fresh JAX context with the job's seed (its XML):

- shared context: four gate-mode jobs over one context, each job's files
  the JAX serve's;
- the chaos matrix: seeded ``serve.preempt@job:``, ``search.node@job:``
  and ``serve.requeue`` schedules over eight jobs, every job's circuits
  its standalone run's;
- a poison job quarantined without touching its neighbours or the shared
  context; priority preemption; drain and recovery; the per-attempt
  timeout;
- merged waves against ``merge=False`` on the device route (toy boxes
  whose node sweeps dispatch): fewer dispatches, the same files; a
  randomized wave; chaos and a poison lane in merged waves; a drain in
  the middle of a merged wave (the waves sidecar, regrouping);
- ``@job:`` and ``@tenant:`` fault qualifiers, the admission site, the
  status view, heartbeat section and watch rendering, the scheduler's
  picks, JobView isolation;
- the CLI: DES-8 one-output jobs and chained planted jobs, merged and
  not, against the JAX CLI's files (goldens of
  ``tests/torch_round_goldens.py``), and its validation messages.

Tolerance: exact equality (bytes).
"""

import hashlib
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from sboxgates_tpu.graph.state import State as JState
from sboxgates_tpu.search import Options as JOptions
from sboxgates_tpu.search import SearchContext as JContext
from sboxgates_tpu.search import orchestrator as jorch
from sboxgates_tpu.search import serve as jserve
from sboxgates_tpu.utils.sbox import load_sbox as jload_sbox

from sboxgates_tpu_torch.resilience import faults
from sboxgates_tpu_torch.resilience.deadline import DeadlineConfig
from sboxgates_tpu_torch.search import Options, SearchContext
from sboxgates_tpu_torch.search.fleet import toy_fleet_boxes
from sboxgates_tpu_torch.search.serve import (
    DONE,
    QUARANTINED,
    QUEUED,
    RUNNING,
    JobView,
    ServeClosed,
    ServeJob,
    ServeOrchestrator,
    job_seed,
    lane_bucket,
)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_round_goldens as goldens  # noqa: E402

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
DES = os.path.join(DATA, "des_s1.txt")
FA = os.path.join(DATA, "crypto1_fa.txt")


@pytest.fixture(autouse=True)
def _clean_faults():
    from sboxgates_tpu.resilience import faults as jfaults

    faults.disarm()
    jfaults.disarm()
    yield
    faults.disarm()
    jfaults.disarm()


def xml_digests(d):
    return {
        f: hashlib.sha256(open(os.path.join(d, f), "rb").read()).hexdigest()
        for f in sorted(os.listdir(d)) if f.endswith(".xml")
    }


def job_files(d):
    """A job directory's XML files and journals."""
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))
            if f.endswith(".xml") or f.startswith("search.journal")}


def jax_standalone(tmp_dir, sbox_path, output, seed, **opts):
    """The JAX package's run of one job on a fresh context with its seed."""
    ctx = JContext(JOptions(seed=seed, **opts))
    sbox, num_inputs = jload_sbox(sbox_path, 0)
    targets = jorch.make_targets(sbox)
    st = JState.init_inputs(num_inputs)
    os.makedirs(tmp_dir, exist_ok=True)
    if output >= 0:
        jorch.generate_graph_one_output(ctx, st, targets, output,
                                        save_dir=tmp_dir, log=lambda s: None)
    else:
        jorch.generate_graph(ctx, st, targets, save_dir=tmp_dir,
                             log=lambda s: None)
    return xml_digests(tmp_dir)


def make_orch(tmp_path, iterations=1, lanes=2, retries=2, seed=11,
              timeout_s=0.0, backoff_s=0.01, sub="serve", merge=None,
              **opts):
    ctx = SearchContext(Options(seed=seed, iterations=iterations,
                                device="cpu", **opts))
    orch = ServeOrchestrator(
        ctx, str(tmp_path / sub), lanes=lanes,
        deadline=DeadlineConfig(budget_s=timeout_s, retries=retries,
                                backoff_s=backoff_s),
        log=lambda s: None, merge=merge,
    )
    return ctx, orch


JOB_SET = [
    ("j0", DES, 0, "acme", 0),
    ("j1", DES, 1, "acme", 0),
    ("j2", DES, 2, "blue", 0),
    ("j3", DES, 3, "blue", 0),
    ("j4", FA, 0, "core", 0),
    ("j5", DES, 0, "core", 0),
    ("j6", DES, 1, "blue", 0),
    ("j7", FA, 0, "acme", 0),
]


def submit_all(orch, jobs=JOB_SET, job_cls=ServeJob):
    return [orch.submit(job_cls(job_id=j, sbox_path=p, output=o, tenant=t,
                                priority=pr))
            for j, p, o, t, pr in jobs]


def run(orch, timeout_s=240):
    orch.start()
    view = orch.run_until_idle(timeout_s=timeout_s)
    orch.stop()
    return view


def check_standalone(tmp_path, orch, jobs, **opts):
    for j in jobs:
        ref = jax_standalone(str(tmp_path / f"ref-{j.job_id}"), j.sbox_path,
                             j.output, int(j.seed), **opts)
        got = xml_digests(os.path.join(orch.root, j.job_id))
        assert got == ref, j.job_id


def _wait_state(orch, job_id, state, timeout_s=30.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        if orch.status_view()["jobs"][job_id]["state"] == state:
            return True
        time.sleep(0.01)
    return False


def test_serve_runs_jobs_on_shared_context_as_the_jax_serve(tmp_path):
    ctx, orch = make_orch(tmp_path, lanes=2)
    submit_all(orch, JOB_SET[:4])
    view = run(orch)
    assert view["counts"][DONE] == 4, view
    jctx = JContext(JOptions(seed=11, iterations=1))
    jorch_ = jserve.ServeOrchestrator(
        jctx, str(tmp_path / "jax"), lanes=2,
        deadline=jserve.DeadlineConfig(budget_s=0.0, retries=2,
                                       backoff_s=0.01),
        log=lambda s: None,
    )
    submit_all(jorch_, JOB_SET[:4], jserve.ServeJob)
    jview = run(jorch_)
    assert jview["counts"][DONE] == 4
    for jid in ("j0", "j1", "j2", "j3"):
        d = os.path.join(orch.root, jid)
        names = os.listdir(d)
        assert {"metrics.json", "telemetry.jsonl",
                "search.journal.jsonl"} <= set(names)
        assert job_files(d) == job_files(os.path.join(jorch_.root, jid)), jid
        snap = json.load(open(os.path.join(d, "metrics.json")))
        assert snap["config"]["job"] == jid
    s = ctx.stats
    assert s["serve_jobs_admitted"] == 4
    assert s.get("serve_quarantined", 0) == 0
    hists = s.histograms()
    for h in ("serve_queue_wait_s", "job_time_to_first_hit_s", "job_seconds"):
        assert hists[h]["count"] == 4
    assert s.undeclared() == set()
    assert job_seed(11, "j0") == jserve.job_seed(11, "j0")


def test_chaos_matrix_bit_identical(tmp_path):
    rng = np.random.default_rng(42)
    ctx, orch = make_orch(tmp_path, iterations=2, lanes=3, retries=4)
    jobs = submit_all(orch)
    for v in rng.choice([j.job_id for j in jobs], size=3, replace=False):
        faults.arm(f"serve.preempt@job:{v}", "raise",
                   str(int(rng.integers(1, 3))))
    for v in rng.choice([j.job_id for j in jobs], size=2, replace=False):
        faults.arm(f"search.node@job:{v}", "raise",
                   str(int(rng.integers(1, 4))))
    faults.arm("serve.requeue", "raise", "2")
    view = run(orch)
    assert view["counts"][DONE] == len(jobs), view
    assert ctx.stats["serve_preemptions"] >= 1
    check_standalone(tmp_path, orch, jobs, iterations=2)
    assert ctx.stats.undeclared() == set()


def test_poison_job_quarantined_healthy_tenants_unaffected(tmp_path):
    ctx, orch = make_orch(tmp_path, lanes=2, retries=1)
    jobs = submit_all(orch, JOB_SET[:3])
    poison = orch.submit(ServeJob(job_id="poison", sbox_path=DES, output=0,
                                  tenant="evil"))
    faults.arm("search.node@job:poison", "raise", "1+")
    view = run(orch)
    assert view["jobs"]["poison"]["state"] == QUARANTINED
    assert view["counts"][QUARANTINED] == 1 and view["counts"][DONE] == 3
    assert ctx.stats["serve_quarantined"] == 1
    assert poison.failures == 2
    assert ctx.device_degraded is False
    pdir = os.path.join(orch.root, "poison")
    assert any(n.startswith("flight-") for n in os.listdir(pdir))
    check_standalone(tmp_path, orch, jobs)


def test_priority_preemption_resumes_bit_identical(tmp_path):
    ctx, orch = make_orch(tmp_path, iterations=4, lanes=1)
    low = orch.submit(ServeJob(job_id="low", sbox_path=DES, output=0,
                               tenant="t", priority=0))
    orch.start()
    assert _wait_state(orch, "low", RUNNING)
    high = orch.submit(ServeJob(job_id="high", sbox_path=FA, output=0,
                                tenant="t", priority=5))
    view = orch.run_until_idle(timeout_s=120)
    orch.stop()
    assert view["counts"][DONE] == 2, view
    assert low.preemptions >= 1 and ctx.stats["serve_preemptions"] >= 1
    check_standalone(tmp_path, orch, [low, high], iterations=4)


def test_drain_snapshots_requeues_and_recovers(tmp_path):
    ctx, orch = make_orch(tmp_path, iterations=3, lanes=2)
    jobs = submit_all(orch, JOB_SET[:3])
    orch.start()
    assert _wait_state(orch, "j0", RUNNING)
    view = orch.drain(timeout_s=30)
    assert view["draining"]
    assert all(r["state"] in (QUEUED, DONE) for r in view["jobs"].values())
    with pytest.raises(ServeClosed):
        orch.submit(ServeJob(job_id="late", sbox_path=DES, output=0))
    preempted = [jid for jid, r in view["jobs"].items()
                 if r["state"] == QUEUED and r.get("preemptions", 0) > 0]
    assert preempted, view
    for jid in preempted:
        d = os.path.join(orch.root, jid)
        names = os.listdir(d)
        assert "metrics.json" in names
        assert any(n.startswith("flight-") for n in names)
        lines = [json.loads(x) for x in open(os.path.join(d, "telemetry.jsonl"))]
        assert lines[-1]["kind"] == "final"
    ctx2, orch2 = make_orch(tmp_path, iterations=3, lanes=2)
    for j in jobs:
        orch2.submit(ServeJob(job_id=j.job_id, sbox_path=j.sbox_path,
                              output=j.output, tenant=j.tenant, seed=j.seed))
    view2 = run(orch2)
    assert view2["counts"][DONE] == 3, view2
    check_standalone(tmp_path, orch2, jobs, iterations=3)


def test_job_timeout_rides_deadline_machinery(tmp_path):
    ctx, orch = make_orch(tmp_path, iterations=2, lanes=2, retries=1,
                          timeout_s=1e-9)
    orch.submit(ServeJob(job_id="slow", sbox_path=DES, output=0))
    view = run(orch, 60)
    assert view["jobs"]["slow"]["state"] == QUARANTINED
    assert "DispatchTimeout" in view["jobs"]["slow"]["error"]


def test_admission_fair_share_and_bucket_grouping(tmp_path):
    ctx, orch = make_orch(tmp_path, lanes=2)
    a0 = orch.submit(ServeJob(job_id="a0", sbox_path=DES, tenant="a"))
    orch.submit(ServeJob(job_id="a1", sbox_path=DES, tenant="a"))
    b0 = orch.submit(ServeJob(job_id="b0", sbox_path=DES, tenant="b"))
    hi = orch.submit(ServeJob(job_id="hi", sbox_path=DES, tenant="a",
                              priority=3))
    with orch._cv:
        picks = orch._admit_locked(time.perf_counter())
    # Priority first, then fair share (b before a's second job).
    assert [j.job_id for j in picks] == ["hi", "b0"]
    for j in (hi, b0):
        j.state = RUNNING
    with orch._cv:
        assert orch._admit_locked(time.perf_counter()) == []
    assert a0.bucket == 64


def test_wave_affinity_and_flagged_victims(tmp_path):
    ctx, orch = make_orch(tmp_path, lanes=2)
    a = orch.submit(ServeJob(job_id="a", sbox_path=DES))
    orch.submit(ServeJob(job_id="b", sbox_path=DES))
    c = orch.submit(ServeJob(job_id="c", sbox_path=DES))
    a.last_wave = c.last_wave = "a,c"
    with orch._cv:
        picks = orch._admit_locked(time.perf_counter())
    assert [j.job_id for j in picks] == ["a", "c"]
    for j in picks:
        j.state = RUNNING
    a._preempt.set()
    w = orch.submit(ServeJob(job_id="w", sbox_path=DES, priority=9))
    w2 = orch.submit(ServeJob(job_id="w2", sbox_path=DES, priority=9))
    with orch._cv:
        targets = orch._preempt_targets_locked(time.perf_counter())
    assert [t.job_id for t in targets] == ["c"]
    del w, w2


def test_serve_helpers_and_closed_queue(tmp_path):
    for args in [(5, "a"), (5, "b"), (6, "a"), (0, "job00-des_s1")]:
        assert job_seed(*args) == jserve.job_seed(*args)
    for n in (1, 2, 3, 33, 10**6):
        assert lane_bucket(n) == jserve.lane_bucket(n)
    ctx, orch = make_orch(tmp_path)
    orch.submit(ServeJob(job_id="dup", sbox_path=DES))
    with pytest.raises(ValueError):
        orch.submit(ServeJob(job_id="dup", sbox_path=DES))


def test_job_and_tenant_targeted_fault_specs():
    spec = faults.parse_spec("serve.preempt@job:j-3:raise@2")
    assert "serve.preempt@job:j-3" in spec
    with pytest.raises(ValueError):
        faults.parse_spec("serve:preempt:raise")
    faults.arm("serve.preempt@job:j3", "raise", "1")
    faults.arm("store.get@tenant:acme", "raise", "1+")
    fired = {}

    def work(job, tenant):
        faults.set_job(job)
        faults.set_tenant(tenant)
        hits = 0
        for site in ("serve.preempt", "serve.preempt", "store.get"):
            try:
                faults.fault_point(site)
            except faults.InjectedFault:
                hits += 1
        fired[job] = hits
        faults.set_job(None)
        faults.set_tenant(None)

    threads = [threading.Thread(target=work, args=a)
               for a in (("j3", "blue"), ("j4", "acme"))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert fired == {"j3": 1, "j4": 1}
    assert faults.hit_count("serve.preempt@job:j3") == 2
    assert faults.hit_count("store.get@tenant:acme") == 1
    faults.fault_point("serve.preempt")


def test_job_and_tenant_faults_from_the_environment(monkeypatch):
    faults.arm("serve.admit@job:env-job", "raise", "1")
    faults.arm("serve.drain@tenant:env-ten", "raise", "1")
    faults.fault_point("serve.admit")
    monkeypatch.setenv("SBG_FAULT_JOB", "env-job")
    monkeypatch.setenv("SBG_FAULT_TENANT", "env-ten")
    with pytest.raises(faults.InjectedFault, match="serve.admit@job:env-job"):
        faults.fault_point("serve.admit")
    with pytest.raises(faults.InjectedFault,
                       match="serve.drain@tenant:env-ten"):
        faults.fault_point("serve.drain")


def test_serve_admit_fault_site_is_loud(tmp_path):
    ctx, orch = make_orch(tmp_path)
    faults.arm("serve.admit", "raise", "1")
    with pytest.raises(faults.InjectedFault):
        orch.submit(ServeJob(job_id="x", sbox_path=DES))
    assert "x" not in orch.status_view()["jobs"]
    assert ctx.stats.get("serve_jobs_admitted", 0) == 0


def test_status_view_watch_render_and_heartbeat_section(tmp_path):
    from sboxgates_tpu_torch.telemetry.heartbeat import Heartbeat
    from sboxgates_tpu_torch.telemetry.watch import render, render_serve

    ctx, orch = make_orch(tmp_path, lanes=2)
    submit_all(orch, JOB_SET[:2])
    hb_dir = str(tmp_path / "hb")
    hb = Heartbeat(ctx.stats, hb_dir, interval_s=0).start()
    hb.add_provider("serve", orch.status_view)
    view = run(orch)
    hb.stop()
    assert view["schema"] == 1 and view["lane_bucket"] == 2
    for row in view["jobs"].values():
        assert row["state"] == DONE and "ttfh_s" in row
    final = [json.loads(x) for x in
             open(os.path.join(hb_dir, "telemetry.jsonl"))][-1]
    assert final["serve"]["counts"][DONE] == 2
    text = render(final)
    assert "serve lanes=2" in text and "done=2" in text
    block = "\n".join(render_serve(final["serve"]))
    assert "j0" in block and "tenant=acme" in block


def test_status_server_serves_the_queue_view(tmp_path):
    import urllib.request

    from sboxgates_tpu_torch.telemetry.status import StatusServer

    ctx, orch = make_orch(tmp_path, lanes=2)
    srv = StatusServer(ctx.stats, port=0).start()
    try:
        srv.add_provider("serve", orch.status_view)
        orch.submit(ServeJob(job_id="q", sbox_path=FA, output=0))
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/status", timeout=10) as r:
            doc = json.loads(r.read())
        assert doc["serve"]["jobs"]["q"]["state"] == QUEUED
    finally:
        srv.shutdown()


def test_jobview_isolation(tmp_path):
    ctx = SearchContext(Options(seed=3, device="cpu"))
    before = ctx.rng_snapshot()
    v = JobView(ctx, 1234)
    ref = np.random.default_rng(1234)
    assert v.next_seed() == int(ref.integers(0, 2**31, size=256)[0])
    assert ctx.rng_snapshot() == before
    assert v.pair_table is ctx.pair_table
    assert v._table_cache is ctx._table_cache
    v.stats.inc("lut5_candidates", 7)
    assert ctx.stats.get("lut5_candidates", 0) == 0
    ctx.stats.merge(v.stats)
    assert ctx.stats["lut5_candidates"] == 7


# -- merged waves -------------------------------------------------------------

#: Node heads on the (CPU) device, so a merged wave's rendezvous merges.
DEVOPTS = dict(lut_graph=True, randomize=False, native=False)
JDEVOPTS = dict(lut_graph=True, randomize=False, host_small_steps=False,
                native_engine=False, warmup=False)


def _toy_files(tmp_path, n=8):
    d = tmp_path / "boxes"
    os.makedirs(d, exist_ok=True)
    paths = []
    for i, bj in enumerate(toy_fleet_boxes(n)):
        p = str(d / f"toy{i}.txt")
        with open(p, "w") as f:
            f.write(" ".join("%02x" % v for v in bj.sbox[:8]))
        paths.append(p)
    return paths


def test_merged_wave_fewer_dispatches_same_files(tmp_path):
    paths = _toy_files(tmp_path)
    ctx_u, orch_u = make_orch(tmp_path, lanes=8, merge=False, sub="unmerged",
                              **DEVOPTS)
    for i, p in enumerate(paths):
        orch_u.submit(ServeJob(job_id=f"t{i}", sbox_path=p, output=0,
                               tenant=f"ten{i % 3}"))
    assert run(orch_u)["counts"][DONE] == 8
    assert ctx_u.stats.get("serve_merged_dispatches", 0) == 0
    ctx, orch = make_orch(tmp_path, lanes=8, **DEVOPTS)
    jobs = [orch.submit(ServeJob(job_id=f"t{i}", sbox_path=p, output=0,
                                 tenant=f"ten{i % 3}"))
            for i, p in enumerate(paths)]
    assert run(orch)["counts"][DONE] == 8
    s = ctx.stats
    assert s["serve_merged_dispatches"] >= 1
    assert s.histograms()["serve_wave_lanes"]["max"] == 8.0
    assert s["fleet_submits"] > s["serve_merged_dispatches"]
    assert int(s["device_dispatches"]) * 2 <= int(ctx_u.stats["device_dispatches"])
    for j in jobs:
        d = os.path.join(orch.root, j.job_id)
        assert job_files(d) == job_files(os.path.join(orch_u.root, j.job_id))
    for j in jobs:
        ref = jax_standalone(str(tmp_path / f"ref-{j.job_id}"), j.sbox_path,
                             0, int(j.seed), **JDEVOPTS)
        assert xml_digests(os.path.join(orch.root, j.job_id)) == ref


def test_merged_wave_randomized_draw_stream_matches_standalone(tmp_path):
    paths = _toy_files(tmp_path, n=4)
    ctx, orch = make_orch(tmp_path, lanes=4, **dict(DEVOPTS, randomize=True))
    jobs = [orch.submit(ServeJob(job_id=f"r{i}", sbox_path=p, output=0))
            for i, p in enumerate(paths)]
    assert run(orch)["counts"][DONE] == 4
    for j in jobs:
        ref = jax_standalone(str(tmp_path / f"ref-{j.job_id}"), j.sbox_path,
                             0, int(j.seed), **dict(JDEVOPTS, randomize=True))
        assert xml_digests(os.path.join(orch.root, j.job_id)) == ref


def test_merged_chaos_matrix_and_poison_lane(tmp_path):
    rng = np.random.default_rng(42)
    paths = _toy_files(tmp_path)
    ctx, orch = make_orch(tmp_path, lanes=4, retries=4, **DEVOPTS)
    jobs = [orch.submit(ServeJob(job_id=f"t{i}", sbox_path=p, output=0,
                                 tenant=f"ten{i % 3}"))
            for i, p in enumerate(paths)]
    poison = orch.submit(ServeJob(job_id="poison", sbox_path=paths[0],
                                  output=0, tenant="evil"))
    for v in rng.choice([j.job_id for j in jobs], size=2, replace=False):
        faults.arm(f"serve.preempt@job:{v}", "raise", "1")
    kill = rng.choice([j.job_id for j in jobs], size=1)[0]
    faults.arm(f"search.node@job:{kill}", "raise", "1")
    faults.arm("serve.wave@job:poison", "raise", "1+")
    faults.arm("search.node@tenant:evil", "raise", "1+")
    view = run(orch)
    assert view["jobs"]["poison"]["state"] == QUARANTINED, view
    assert poison.failures == 5
    assert view["counts"][DONE] == 8, view
    assert ctx.stats["serve_preemptions"] >= 1
    assert ctx.stats["serve_merged_dispatches"] >= 1
    for j in jobs:
        ref = jax_standalone(str(tmp_path / f"ref-{j.job_id}"), j.sbox_path,
                             0, int(j.seed), **JDEVOPTS)
        assert xml_digests(os.path.join(orch.root, j.job_id)) == ref


def test_drain_mid_merged_wave_no_stranded_lanes(tmp_path):
    paths = _toy_files(tmp_path, n=4)
    ctx, orch = make_orch(tmp_path, lanes=4, iterations=4, **DEVOPTS)
    jobs = [orch.submit(ServeJob(job_id=f"t{i}", sbox_path=p, output=0))
            for i, p in enumerate(paths)]
    faults.arm("serve.preempt@job:t0", "raise", "1")
    faults.arm("serve.drain", "raise", "1")
    orch.start()
    assert _wait_state(orch, "t1", RUNNING) or _wait_state(orch, "t0", RUNNING)
    with pytest.raises(faults.InjectedFault):
        orch.drain(timeout_s=30)
    view = orch.drain(timeout_s=60)
    assert all(r["state"] in (QUEUED, DONE) for r in view["jobs"].values())
    recs = [json.loads(x) for x in open(os.path.join(orch.root, "waves.jsonl"))]
    key = next(r["key"] for r in recs if r["requeued"] == "t0")
    assert set(key.split(",")) == {f"t{i}" for i in range(4)}
    ctx2, orch2 = make_orch(tmp_path, lanes=4, iterations=4, **DEVOPTS)
    assert orch2._prior_waves.get("t0") == key
    for j in jobs:
        orch2.submit(ServeJob(job_id=j.job_id, sbox_path=j.sbox_path,
                              output=j.output, seed=j.seed))
    assert orch2._jobs["t0"].last_wave == key
    assert run(orch2)["counts"][DONE] == 4
    for j in jobs:
        ref = jax_standalone(str(tmp_path / f"ref-{j.job_id}"), j.sbox_path,
                             0, int(j.seed), **dict(JDEVOPTS, iterations=4))
        assert xml_digests(os.path.join(orch.root, j.job_id)) == ref


def test_serve_no_merge_env_and_param(tmp_path, monkeypatch):
    _, orch = make_orch(tmp_path, lanes=4, merge=False)
    assert orch.merge is False
    monkeypatch.setenv("SBG_SERVE_NO_MERGE", "1")
    _, orch2 = make_orch(tmp_path, lanes=4, sub="s2")
    assert orch2.merge is False
    monkeypatch.delenv("SBG_SERVE_NO_MERGE")
    _, orch3 = make_orch(tmp_path, lanes=1, sub="s3")
    assert orch3.merge is False
    _, orch4 = make_orch(tmp_path, lanes=2, sub="s4")
    assert orch4.merge is True


# -- the CLI ---------------------------------------------------------------------

#: The CLI cases the CPU runs (the device-route and DES serves are the
#: card's, chip_smoke phase 12).
SERVE_CLI = ["serve_chain8", "serve_chain8_nomerge", "serve_des8_o0"]


@pytest.mark.parametrize("case", SERVE_CLI)
def test_serve_cli_writes_the_jax_clis_files(case, tmp_path, monkeypatch):
    _, cmds, _ = goldens.CASES[case]
    argv, env, _ = cmds[-1]
    monkeypatch.chdir(tmp_path)
    goldens.run_port(argv, env, "D")
    goldens.compare_dir(goldens.golden_dir(case), "D")


def test_serve_rejects_incoherent_flags_in_one_line(tmp_path, monkeypatch,
                                                     capsys):
    from sboxgates_tpu import cli as jcli
    from sboxgates_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    d = str(tmp_path / "out")
    for argv in (
        ["--serve", DES],
        ["--serve", "--fleet", DES, "--output-dir", d],
        ["--serve", "--batch-iterations", DES, "--output-dir", d],
        ["--serve", "--permute-sweep", DES, "--output-dir", d],
        ["--serve", "--serial-jobs", DES, "--output-dir", d],
        ["--serve", "--serve-lanes", "0", DES, "--output-dir", d],
        ["--serve", "--serve-retries", "-1", DES, "--output-dir", d],
        ["--serve", "--serve-timeout", "0", DES, "--output-dir", d],
        ["--serve", "--resume-run", d],
        ["--serve-no-merge", DES],
        ["--result-store", "S", "-c", DES],
        ["--serve", "--result-store", "S", DES],
        ["--chain-rounds", "-1", DES],
        ["--chain-rounds", "4", DES],
        ["-l", "--chain-rounds", "4", "-i", "2", DES],
        ["-l", "--chain-rounds", "4", "-o", "0", DES],
    ):
        assert cli.main([*argv, "--device", "cpu"]) == 1, argv
        err = capsys.readouterr().err.strip()
        assert err.count("\n") == 0 and "Traceback" not in err, (argv, err)
        assert jcli.main(argv) != 0
        assert capsys.readouterr().err.strip().splitlines()[-1] == err, argv
        assert not list(tmp_path.glob("search.journal.*")), argv


@pytest.mark.parametrize("flags", [
    ["--mesh"],
    ["--shard-sweep"], ["--coordinator", "localhost:1"],
    ["--num-processes", "2"], ["--process-id", "0", "--num-processes", "2"],
    ["--fleet-candidates", "2", "--fleet"],
])
def test_unported_flags_fail_in_one_line(flags, tmp_path, monkeypatch, capsys):
    """The mesh, process and fleet flags run in the port; with ``--serve``
    both CLIs refuse them, in one line, the JAX CLI's (a serve run is one
    process over its local devices), before any group is joined or file
    written."""
    from sboxgates_tpu import cli as jcli
    from sboxgates_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    argv = [*flags, "--serve", "--output-dir", str(tmp_path), "-l", DES]
    assert cli.main([*argv, "--device", "cpu"]) == 1
    err = capsys.readouterr().err.strip()
    assert err.count("\n") == 0 and err
    assert jcli.main(argv) == 1
    assert capsys.readouterr().err.strip().splitlines()[-1] == err
    assert not os.listdir(tmp_path)
