"""The port's canonical keys and result store against the JAX package's.

- ``core/canon``: ``canonicalize``, ``exact_key``, ``exact_multi_key`` and
  the transform algebra against the JAX package's on random tables of 3
  to 8 inputs, their frames and symmetric (over-cap) orbits: the same keys,
  digests and transforms, so a store written by either package answers
  the other.
- ``store/``: the frame rewrite verified over all 2^8 inputs; a store the
  JAX package wrote answers the port's queries (every frame of every
  published circuit, the all-outputs key and the LUT sub-tables) and the
  reverse; the entry files of both packages' publishes byte for byte;
  corrupt entries quarantined as misses; the ``store.get``, ``store.put``
  and ``store.index`` sites (and ``@job:``) degrading; a read-only store;
  the serve's zero-dispatch repeat queries and the cross-process frontier.
- The CLI: a re-serve of a store the first serve filled, every job a hit
  with no device dispatch, against the JAX CLI's files and store entries
  (goldens of ``tests/torch_round_goldens.py``), and the port serving the
  JAX CLI's store.

Tolerance: exact equality (digests, words and bytes).
"""

import hashlib
import json
import os
import shutil
import sys
import time

import numpy as np
import pytest
import torch

from sboxgates_tpu.core import canon as jcanon
from sboxgates_tpu.graph.state import State as JState
from sboxgates_tpu.store import ResultStore as JResultStore

from sboxgates_tpu_torch.core import canon
from sboxgates_tpu_torch.core import ttable as tt
from sboxgates_tpu_torch.graph.state import GATES, State
from sboxgates_tpu_torch.resilience import faults
from sboxgates_tpu_torch.resilience.deadline import DeadlineConfig
from sboxgates_tpu_torch.search import Options, SearchContext
from sboxgates_tpu_torch.search.serve import DONE, ServeJob, ServeOrchestrator
from sboxgates_tpu_torch.store import ResultStore, rewrite_state

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_round_goldens as goldens  # noqa: E402

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
DES = os.path.join(DATA, "des_s1.txt")


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.disarm()
    yield
    faults.disarm()


def random_table(rng, n):
    bits = np.zeros(tt.TABLE_BITS, dtype=bool)
    bits[: 1 << n] = rng.integers(0, 2, 1 << n).astype(bool)
    return tt.from_bits(bits)


def random_transform(rng, n):
    return canon.Transform(
        tuple(int(v) for v in rng.permutation(n)),
        tuple(int(v) for v in rng.integers(0, 2, n)),
        int(rng.integers(0, 2)),
    )


def jt(t):
    return jcanon.Transform(t.perm, t.neg, t.comp)


def random_circuit(n, n_gates, seed, cls=State):
    r = np.random.default_rng(seed)
    st = cls.init_inputs(n)
    for _ in range(n_gates):
        kind = r.integers(0, 3)
        if kind == 0:
            a, b = r.choice(st.num_gates, 2, replace=False)
            st.add_gate(int(r.integers(1, 15)), int(a), int(b), GATES)
        elif kind == 1 and st.num_gates >= 3:
            a, b, c = r.choice(st.num_gates, 3, replace=False)
            st.add_lut(int(r.integers(1, 256)), int(a), int(b), int(c))
        else:
            st.add_not_gate(int(r.integers(0, st.num_gates)), GATES)
    st.outputs[0] = st.num_gates - 1
    return st


def xml_digests(d):
    return {f: hashlib.sha256(open(os.path.join(d, f), "rb").read()).hexdigest()
            for f in sorted(os.listdir(d)) if f.endswith(".xml")}


def objects(root):
    """{relative path: bytes} of a store's entry files."""
    out = {}
    base = os.path.join(root, "objects")
    for d, _, files in os.walk(base):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, base)] = open(p, "rb").read()
    return out


# -- canonical keys ---------------------------------------------------------


@pytest.mark.parametrize("n", [3, 4, 5, 6, 8])
def test_canonical_keys_and_transforms_match_jax(n):
    rng = np.random.default_rng(n)
    mask = tt.mask_table(n)
    for _ in range(6):
        T = random_table(rng, n)
        for frame in range(3):
            T2 = T if frame == 0 else canon.apply_transform(
                random_transform(rng, n), T)
            for metric in (0, 1):
                key, tr = canon.canonicalize(T2, mask, metric)
                jkey, jtr = jcanon.canonicalize(T2, mask, metric)
                assert key == jkey
                assert (tr.perm, tr.neg, tr.comp) == (jtr.perm, jtr.neg,
                                                      jtr.comp)
                assert canon.exact_key(T2, mask, metric) == \
                    jcanon.exact_key(T2, mask, metric)
        # A non-standard mask keys exactly, don't-care bits ignored.
        odd = rng.integers(0, 2**32, 8, dtype=np.uint64).astype(np.uint32)
        assert canon.canonicalize(T, odd, 0) == (jcanon.canonicalize(T, odd, 0)[0],
                                                 None)
    targets = [random_table(rng, n) for _ in range(4)]
    assert canon.exact_multi_key(targets, mask, 0) == \
        jcanon.exact_multi_key(targets, mask, 0)


def test_symmetric_orbits_fall_back_to_the_same_exact_key():
    for n in (6, 8):
        mask = tt.mask_table(n)
        x = tt.zero()
        for i in range(n):
            x = x ^ tt.input_table(i)
        key, tr = canon.canonicalize(x, mask, GATES)
        assert tr is None and key.startswith("x")
        assert key == jcanon.canonicalize(x, mask, GATES)[0]


def test_transform_algebra_matches_jax():
    rng = np.random.default_rng(0)
    for n in (3, 5, 8):
        for _ in range(8):
            T = random_table(rng, n)
            t1, t2 = random_transform(rng, n), random_transform(rng, n)
            c = canon.compose(t2, t1)
            jc = jcanon.compose(jt(t2), jt(t1))
            assert (c.perm, c.neg, c.comp) == (jc.perm, jc.neg, jc.comp)
            i = canon.invert(t1)
            ji = jcanon.invert(jt(t1))
            assert (i.perm, i.neg, i.comp) == (ji.perm, ji.neg, ji.comp)
            assert np.array_equal(canon.apply_transform(c, T),
                                  jcanon.apply_transform(jc, T))
            assert canon.compose(i, t1).is_identity()


def test_rewrite_state_verified_over_all_inputs():
    rng = np.random.default_rng(3)
    for seed in range(6):
        n = 3 + seed % 4
        st = random_circuit(n, 7, seed)
        mask = tt.mask_table(n)
        t = random_transform(rng, n)
        out = rewrite_state(st, t)
        want = canon.apply_transform(t, st.tables[st.outputs[0]] & mask)
        assert bool(tt.eq_mask(out.tables[out.outputs[0]], want, mask))
        assert rewrite_state(st, canon.identity_transform(n)).gates == st.gates


# -- the store across packages ----------------------------------------------------


def _publish(store, cls, n_circuits=4, seed=0):
    """Publishes random circuits (5-8 inputs) and a multi-output state of
    ``cls`` (either package's State); returns the published (inputs,
    target, mask) triples and the multi query."""
    pubs = []
    for i in range(n_circuits):
        n = 5 + i % 4
        st = random_circuit(n, 9, seed + i, cls=cls)
        mask = tt.mask_table(n)
        T = st.tables[st.outputs[0]]
        store.put_state(st, T, mask, GATES, sub_tables=True)
        pubs.append((n, T, mask))
    multi = random_circuit(6, 12, seed + 99, cls=cls)
    multi.outputs[1] = multi.num_gates - 2
    multi.outputs[2] = multi.num_gates - 3
    mask6 = tt.mask_table(6)
    targets = [multi.tables[multi.outputs[b]] for b in range(3)]
    store.put_multi(multi, targets, mask6, GATES, sub_tables=True)
    store.flush()
    return pubs, (targets, mask6)


def _query_all(store, pubs, multi, rng):
    """Every published circuit queried in its own frame and (when its key
    is canonical, not an over-cap orbit's exact key) in a random other
    frame, and the all-outputs query: all hits, re-verified."""
    for n, T, mask in pubs:
        frames = [None]
        if canon.canonicalize(T, mask, GATES)[1] is not None:
            frames.append(random_transform(rng, n))
        for frame in frames:
            q = T if frame is None else canon.apply_transform(frame, T)
            kind, hit = store.fetch(q, mask, GATES)
            assert kind == "hit"
            assert bool(tt.eq_mask(hit.state.tables[hit.state.outputs[0]], q,
                                   mask))
    kind, hit = store.fetch_multi(multi[0], multi[1], GATES)
    assert kind == "hit"


def test_a_jax_written_store_answers_the_port(tmp_path):
    root = str(tmp_path / "s")
    jstore = JResultStore(root, sync=True)
    pubs, multi = _publish(jstore, JState)
    jstore.close()
    store = ResultStore(root, readonly=True)
    _query_all(store, pubs, multi, np.random.default_rng(5))


def test_a_port_written_store_answers_the_jax_package(tmp_path):
    root = str(tmp_path / "s")
    store = ResultStore(root)
    pubs, multi = _publish(store, State)
    store.close()
    jstore = JResultStore(root, readonly=True)
    _query_all(jstore, pubs, multi, np.random.default_rng(6))


def test_both_packages_write_the_same_entry_files(tmp_path):
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    store, jstore = ResultStore(a, sync=True), JResultStore(b, sync=True)
    _publish(store, State)
    _publish(jstore, JState)
    assert objects(a) and objects(a) == objects(b)


def test_corrupt_entries_quarantined_as_miss(tmp_path):
    root = str(tmp_path / "s")
    store = ResultStore(root, sync=True)
    st = random_circuit(5, 6, 9)
    mask = tt.mask_table(5)
    T = st.tables[st.outputs[0]]
    store.put_state(st, T, mask, GATES)
    assert store.fetch(T, mask, GATES)[0] == "hit"
    (rel,) = objects(root)
    path = os.path.join(root, "objects", rel)
    with open(path, "r+") as f:
        f.truncate(20)
    assert store.fetch(T, mask, GATES)[0] == "miss"
    assert os.listdir(os.path.join(root, "quarantine")) == [
        os.path.basename(path)]
    # An unknown entry version is a plain miss, never quarantined.
    store.put_state(st, T, mask, GATES)
    doc = json.load(open(path))
    doc["v"] = 99
    with open(path, "w") as f:
        json.dump(doc, f)
    assert store.fetch(T, mask, GATES)[0] == "miss"
    assert os.path.exists(path)


def test_store_fault_sites_degrade(tmp_path):
    store = ResultStore(str(tmp_path / "s"), sync=True)
    st = random_circuit(5, 6, 9)
    mask = tt.mask_table(5)
    T = st.tables[st.outputs[0]]
    faults.arm("store.put", "raise", "1")
    store.put_state(st, T, mask, GATES)
    faults.disarm()
    assert store.fetch(T, mask, GATES)[0] == "miss"
    faults.arm("store.index", "raise", "1+")
    store.put_state(st, T, mask, GATES)
    faults.disarm()
    assert not os.path.exists(tmp_path / "s" / "index.jsonl")
    assert store.fetch(T, mask, GATES)[0] == "hit"
    faults.arm("store.get", "raise", "1")
    assert store.fetch(T, mask, GATES) == ("miss", None)
    faults.disarm()
    assert store.fetch(T, mask, GATES)[0] == "hit"
    # A job-qualified put fires only for that job, through the writer
    # thread (the pin rides the queued write).
    store2 = ResultStore(str(tmp_path / "s2"))
    faults.arm("store.put@job:jx", "raise", "1+")
    faults.set_job("jx")
    store2.put_state(st, T, mask, GATES)
    faults.set_job(None)
    store2.flush()
    assert store2.fetch(T, mask, GATES)[0] == "miss"
    store2.put_state(st, T, mask, GATES)
    store2.flush()
    assert store2.fetch(T, mask, GATES)[0] == "hit"
    store.close()
    store2.close()


def test_unwritable_store_degrades_readonly(tmp_path):
    bad = tmp_path / "not-a-dir"
    bad.write_text("occupied")
    store = ResultStore(str(bad))
    assert store.readonly
    st = random_circuit(4, 5, 2)
    mask = tt.mask_table(4)
    store.put_state(st, st.tables[st.outputs[0]], mask, GATES)
    assert store.fetch(st.tables[st.outputs[0]], mask, GATES)[0] == "miss"
    assert store.status_view()["readonly"] is True


# -- the serve with a store ---------------------------------------------------------


def _toy_files(tmp_path, n):
    from sboxgates_tpu_torch.search.fleet import toy_fleet_boxes

    d = tmp_path / "boxes"
    os.makedirs(d, exist_ok=True)
    paths = []
    for i, bj in enumerate(toy_fleet_boxes(n)):
        p = str(d / f"toy{i}.txt")
        with open(p, "w") as f:
            f.write(" ".join("%02x" % v for v in bj.sbox[:8]))
        paths.append(p)
    return paths


def _serve_run(tmp_path, sub, store_dir, paths, output):
    ctx = SearchContext(Options(
        seed=11, lut_graph=True, randomize=False, native=False, device="cpu",
        result_store=store_dir,
    ))
    orch = ServeOrchestrator(ctx, str(tmp_path / sub), lanes=2,
                             deadline=DeadlineConfig(retries=2, backoff_s=0.01),
                             log=lambda s: None)
    jobs = [orch.submit(ServeJob(job_id=f"t{i}", sbox_path=p, output=output))
            for i, p in enumerate(paths)]
    orch.start()
    view = orch.run_until_idle(timeout_s=240)
    orch.stop()
    ctx.result_store.close()
    return ctx, orch, view, jobs


def test_serve_repeat_query_zero_dispatch_bit_identical(tmp_path):
    store_dir = str(tmp_path / "store")
    paths = _toy_files(tmp_path, 4)
    ctx1, orch1, v1, _ = _serve_run(tmp_path, "cold", store_dir, paths, 0)
    assert v1["counts"][DONE] == 4, v1
    assert int(ctx1.stats["device_dispatches"]) > 0
    assert int(ctx1.stats["store_misses"]) == 4
    ctx2, orch2, v2, jobs2 = _serve_run(tmp_path, "warm", store_dir, paths, 0)
    assert v2["counts"][DONE] == 4
    assert int(ctx2.stats["store_hits"]) == 4
    assert int(ctx2.stats.get("device_dispatches", 0)) == 0
    assert ctx2.stats.histograms()["store_get_s"]["count"] >= 4
    for j in jobs2:
        row = v2["jobs"][j.job_id]
        assert row["store"] == "hit" and "queue_wait_s" not in row
        warm = xml_digests(os.path.join(orch2.root, j.job_id))
        (fname, digest), = warm.items()
        assert xml_digests(os.path.join(orch1.root, j.job_id))[fname] == digest
        recs = [json.loads(x) for x in open(os.path.join(
            orch2.root, j.job_id, "search.journal.jsonl"))]
        assert recs[0]["config"]["store"] == "hit"
        assert recs[-1]["type"] == "run_done"
    assert v2["store"]["hits"] == 4 and ctx2.stats.undeclared() == set()


def test_store_get_job_targeted_fault_degrades_one_tenant(tmp_path):
    store_dir = str(tmp_path / "store")
    paths = _toy_files(tmp_path, 4)
    _serve_run(tmp_path, "cold", store_dir, paths, 0)
    faults.arm("store.get@job:t1", "raise", "1+")
    ctx, orch, view, jobs = _serve_run(tmp_path, "warm", store_dir, paths, 0)
    assert view["counts"][DONE] == 4
    assert view["jobs"]["t1"].get("store") is None
    assert int(ctx.stats["store_hits"]) == 3
    assert int(ctx.stats["store_misses"]) == 1


def test_drained_frontier_resumes_across_processes(tmp_path):
    """A drained serve publishes its interrupted job's frontier; a new
    orchestrator elsewhere seeds from it and finishes as an uninterrupted
    JAX run with the job's seed."""
    from sboxgates_tpu.search import Options as JOptions
    from sboxgates_tpu.search import SearchContext as JContext
    from sboxgates_tpu.search import orchestrator as jorch
    from sboxgates_tpu.utils.sbox import load_sbox as jload

    store_dir = str(tmp_path / "store")
    ctx1 = SearchContext(Options(seed=11, iterations=4, device="cpu",
                                 result_store=store_dir))
    orch1 = ServeOrchestrator(ctx1, str(tmp_path / "r1"), lanes=1,
                              deadline=DeadlineConfig(retries=3, backoff_s=5.0),
                              log=lambda s: None)
    faults.arm("serve.preempt@job:j0", "raise", "2")
    orch1.submit(ServeJob(job_id="j0", sbox_path=DES, output=0))
    orch1.start()
    t0 = time.monotonic()
    while time.monotonic() - t0 < 60:
        if orch1.status_view()["jobs"]["j0"].get("preemptions", 0):
            break
        time.sleep(0.02)
    faults.disarm()
    orch1.drain(timeout_s=30)
    ctx1.result_store.flush()
    assert int(ctx1.stats["store_puts"]) >= 1
    ctx2 = SearchContext(Options(seed=11, iterations=4, device="cpu",
                                 result_store=store_dir))
    orch2 = ServeOrchestrator(ctx2, str(tmp_path / "r2"), lanes=1,
                              deadline=DeadlineConfig(retries=2, backoff_s=0.01),
                              log=lambda s: None)
    j0b = orch2.submit(ServeJob(job_id="j0", sbox_path=DES, output=0))
    assert j0b.store == "partial"
    orch2.start()
    v2 = orch2.run_until_idle(timeout_s=120)
    orch2.stop()
    assert v2["counts"][DONE] == 1 and v2["jobs"]["j0"]["store"] == "partial"
    ref = str(tmp_path / "ref")
    os.makedirs(ref)
    jctx = JContext(JOptions(seed=int(j0b.seed), iterations=4))
    sbox, n = jload(DES, 0)
    jorch.generate_graph_one_output(jctx, JState.init_inputs(n),
                                    jorch.make_targets(sbox), 0,
                                    save_dir=ref, log=lambda s: None)
    assert xml_digests(os.path.join(orch2.root, "j0")) == xml_digests(ref)


def test_watch_renders_store_section():
    from sboxgates_tpu_torch.telemetry.watch import render_serve

    serve = {
        "lanes": 2, "lane_bucket": 2, "merge": True, "waves": 0,
        "draining": False,
        "counts": {"queued": 0, "running": 0, "preempted": 0,
                   "quarantined": 0, "done": 2},
        "store": {"hits": 1, "misses": 1, "partial_hits": 0, "puts": 1,
                  "readonly": False},
        "jobs": {"a": {"state": "done", "tenant": "t", "priority": 0,
                       "bucket": 2, "store": "hit", "ttfh_s": 0.001}},
    }
    text = "\n".join(render_serve(serve))
    assert "store hit=1/part=0/miss=1" in text and "store=hit" in text


# -- the CLI ----------------------------------------------------------------------


def test_a_re_serve_hits_the_store_as_the_jax_cli_does(tmp_path, monkeypatch):
    """Two serves sharing a store: the second answers every job from the
    store with no device dispatch; its files and the store's entries are
    the JAX CLI's."""
    _, cmds, _ = goldens.CASES["serve_chain8_store"]
    monkeypatch.chdir(tmp_path)
    for i, (argv, env, _) in enumerate(cmds):
        goldens.run_port(argv, env, "D" if i == len(cmds) - 1 else f"D{i}")
    goldens.compare_dir(goldens.golden_dir("serve_chain8_store"), "D", "S")
    m = json.load(open(os.path.join("D", "metrics.json")))["counters"]
    assert m["store_hits"] == 8 and m.get("device_dispatches", 0) == 0


def test_the_port_serves_the_jax_clis_store(tmp_path, monkeypatch):
    """The store the JAX CLI's serve filled (from the golden) answers the
    port's re-serve: the JAX CLI's files, with no device dispatch."""
    golden = goldens.golden_dir("serve_chain8_store")
    monkeypatch.chdir(tmp_path)
    shutil.copytree(os.path.join(golden, "store"), "S")
    argv, env, _ = goldens.CASES["serve_chain8_store"][1][-1]
    goldens.run_port(argv, env, "D")
    goldens.compare_dir(golden, "D", "S")
    m = json.load(open(os.path.join("D", "metrics.json")))["counters"]
    assert m["store_hits"] == 8 and m.get("device_dispatches", 0) == 0
