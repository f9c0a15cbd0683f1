"""The port's resilience layer against the JAX package's, on the CPU.

- ``SBG_FAULTS`` specs parse to the same schedules (and fail with the same
  messages), and the same calls fire on the same hits;
- a checkpoint write interrupted at ``ckpt.write`` or ``ckpt.replace``
  leaves the old file whole and no temp file; ``latest_valid_state`` skips
  torn and corrupt files as the JAX package's does;
- the journal writes the JAX package's bytes for the same appends
  (snapshots included), reads past a torn tail, refuses a journal without
  ``run_start`` and writes nothing when read-only;
- ``rng_snapshot`` is the JAX context's after the same draws, and a
  snapshot of either context restores the other;
- ``ChunkPrefetcher`` yields the JAX package's chunks at depths 1, 2 and 4
  and raises a producer fault at the chunk it failed on.
"""

import itertools
import json
import os
import sys

import numpy as np
import pytest
import torch

from sboxgates_tpu.ops import combinatorics as jcomb
from sboxgates_tpu.resilience import checkpoint as jckpt
from sboxgates_tpu.resilience import faults as jfaults
from sboxgates_tpu.resilience import journal as jjournal
from sboxgates_tpu.search import context as jctx

from sboxgates_tpu_torch.graph.xmlio import save_state
from sboxgates_tpu_torch.ops import combinatorics as comb
from sboxgates_tpu_torch.resilience import checkpoint as ckpt
from sboxgates_tpu_torch.resilience import faults
from sboxgates_tpu_torch.resilience import journal
from sboxgates_tpu_torch.search import context as tctx

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_states import random_state  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.disarm()
    jfaults.disarm()
    yield
    faults.disarm()
    jfaults.disarm()


# -- fault specs -------------------------------------------------------------

SPECS = [
    "ckpt.write:crash@2",
    "search.node:raise@7",
    "dispatch.sweep:hang@1+",
    "order.score:raise",
    "journal.append:raise@3,ckpt.replace:crash@1",
    "dispatch.sweep@rank:1:hang@2",
    "serve.preempt@job:j03:raise@2",
    "net.auth@tenant:acme:raise",
    " prefetch.produce:raise@4+ , ",
]
BAD_SPECS = [
    "ckpt.write",
    ":raise",
    "ckpt.write:explode",
    "ckpt.write:raise@0",
    "ckpt.write:raise@x",
    "a:b:raise",
    "site@rank:x:raise",
]


def _schedules(specs):
    return {k: (v.action, v.first, v.once) for k, v in specs.items()}


@pytest.mark.parametrize("text", SPECS)
def test_fault_specs_parse_as_in_the_jax_package(text):
    assert _schedules(faults.parse_spec(text)) == _schedules(
        jfaults.parse_spec(text)
    )


@pytest.mark.parametrize("text", BAD_SPECS)
def test_bad_fault_specs_fail_with_the_jax_packages_message(text):
    with pytest.raises(ValueError) as want:
        jfaults.parse_spec(text)
    with pytest.raises(ValueError) as got:
        faults.parse_spec(text)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("when", ["1", "3", "2+", "1+"])
def test_hits_fire_where_the_jax_packages_do(when):
    def fired(mod):
        mod.arm("search.node", "raise", when)
        out = []
        for _ in range(6):
            try:
                mod.fault_point("search.node")
                out.append(False)
            except mod.InjectedFault as e:
                assert isinstance(e, RuntimeError)
                out.append(str(e))
        return out, mod.hit_count("search.node")

    assert fired(faults) == fired(jfaults)
    faults.disarm("search.node")
    assert faults.hit_count("search.node") == 0
    faults.fault_point("search.node")  # disarmed: no effect


def test_qualified_sites_count_on_their_target_only(monkeypatch):
    """One process, no jobs, no tenants: ``@rank:0`` fires and counts on
    its own; any other qualifier parses and never fires.  So do the JAX
    package's at its defaults (rank 0, no job or tenant pinned)."""
    for var in ("SBG_FAULT_RANK", "RANK", "SBG_FAULT_JOB", "SBG_FAULT_TENANT"):
        monkeypatch.delenv(var, raising=False)
    armed = ("dispatch.sweep@rank:0", "dispatch.sweep@rank:1",
             "search.node@job:j1", "search.node@tenant:acme")

    def run(mod):
        for name in armed:
            mod.arm(name, "raise", "2")
        out = []
        for site in ("dispatch.sweep", "search.node") * 3:
            try:
                mod.fault_point(site)
                out.append(None)
            except mod.InjectedFault as e:
                out.append(str(e))
        return out, [mod.hit_count(n) for n in armed]

    got = run(faults)
    assert got == run(jfaults)
    assert got[1] == [3, 0, 0, 0]
    assert got[0][2] == "injected fault at dispatch.sweep@rank:0 (hit 2)"


# -- checkpoints -------------------------------------------------------------


@pytest.mark.parametrize("site", ["ckpt.write", "ckpt.replace"])
def test_interrupted_checkpoint_write_keeps_the_old_file(tmp_path, site):
    st = random_state(12, 1)
    path = save_state(st, str(tmp_path))
    old = open(path, "rb").read()
    faults.arm(site, "raise", "1")
    with pytest.raises(faults.InjectedFault):
        save_state(st.copy(), str(tmp_path))  # a rewrite of the same file
    assert open(path, "rb").read() == old
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(path)]


def test_latest_valid_state_skips_torn_and_corrupt_files(tmp_path):
    d = str(tmp_path)
    paths = []
    for i, g in enumerate((10, 12, 14, 16)):
        p = save_state(random_state(g, i), d)
        os.utime(p, (1000 + i, 1000 + i))
        paths.append(p)
    # The newest is torn (half its bytes), the next one's digest is wrong.
    raw = open(paths[3], "rb").read()
    open(paths[3], "wb").write(raw[: len(raw) // 2])
    os.utime(paths[3], (1003, 1003))
    raw = open(paths[2], "r").read().replace('type="AND"', 'type="OR"', 1)
    open(paths[2], "w").write(raw)
    os.utime(paths[2], (1002, 1002))
    open(os.path.join(d, ckpt.TMP_PREFIX + "x.tmp"), "w").write("partial")
    got = ckpt.latest_valid_state(d)
    want = jckpt.latest_valid_state(d)
    assert got[0] == want[0] == paths[1]
    assert got[1].num_gates == want[1].num_gates == 12
    assert ckpt.clean_stale_tmp(d) == 1
    assert not any(n.startswith(ckpt.TMP_PREFIX) for n in os.listdir(d))
    assert ckpt.latest_valid_state(str(tmp_path / "missing")) is None


# -- journal -----------------------------------------------------------------

CONFIG = {"seed": 7, "lut": True, "input": ["/x/des_s1.txt"], "graph": None}


def _records(n):
    return [
        ("iter_done", dict(it=i, ckpt=f"1-0{i:02d}.xml", max_gates=50 - i,
                           max_sat_metric=2**31 - 1,
                           rng={"bg": {"state": {"state": 2**100 + i}},
                                "seed_buf": [i, 2**31 - 1]}))
        for i in range(n)
    ] + [("run_done", dict(beam=["a.xml"]))]


def _journal_files(d):
    return {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d))}


@pytest.mark.parametrize("n", [0, 3, 7, 8, 9, 17])
def test_journal_writes_the_jax_packages_bytes(tmp_path, n):
    outs = []
    for mod in (jjournal, journal):
        d = str(tmp_path / mod.__name__.split(".")[0])
        j = mod.SearchJournal.start(d, config=dict(CONFIG))
        for rtype, payload in _records(n)[:-1]:
            j.append(rtype, **payload)
        outs.append(_journal_files(d))
        j.append(*_records(0)[0][:1], **_records(0)[0][1])
        outs.append(_journal_files(d))
    assert outs[0] == outs[2] and outs[1] == outs[3]
    snap = json.loads(outs[3][journal.SNAPSHOT_NAME])
    assert snap["version"] == journal.JOURNAL_VERSION == 2
    assert len(snap["records"]) == n + 2


def test_journal_resume_reads_past_a_torn_tail(tmp_path):
    d = str(tmp_path)
    j = journal.SearchJournal.start(d, config=dict(CONFIG))
    for rtype, payload in _records(2)[:-1]:
        j.append(rtype, **payload)
    with open(os.path.join(d, journal.JOURNAL_NAME), "a") as f:
        f.write('{"seq": 3, "type": "iter_do')
    open(os.path.join(d, ckpt.TMP_PREFIX + "y.tmp"), "w").write("x")
    r = journal.SearchJournal.resume(d)
    rj = jjournal.SearchJournal.load_records(d)
    assert r.records == rj and r.seq == 3
    assert r.last("iter_done")["it"] == 1 and len(r.of_type("iter_done")) == 2
    assert r.config == CONFIG and not r.complete
    lines = open(os.path.join(d, journal.JOURNAL_NAME)).read().splitlines()
    assert [json.loads(x) for x in lines] == rj  # the torn tail is gone
    assert not any(n.startswith(ckpt.TMP_PREFIX) for n in os.listdir(d))
    r.append("run_done", beam=[])
    assert journal.SearchJournal.resume(d).complete


def test_journal_falls_back_to_the_snapshot(tmp_path):
    d = str(tmp_path)
    j = journal.SearchJournal.start(d, config=dict(CONFIG))
    open(os.path.join(d, journal.JOURNAL_NAME), "w").write("garbage\n")
    assert journal.SearchJournal.load_records(d) == j.records[:1]


def test_journal_readonly_and_missing_run_start(tmp_path):
    d = str(tmp_path)
    with pytest.raises(journal.JournalError, match="missing run_start"):
        journal.SearchJournal.resume(d)
    with open(os.path.join(d, journal.JOURNAL_NAME), "w") as f:
        f.write(json.dumps({"seq": 0, "type": "iter_done"}) + "\n")
    with pytest.raises(journal.JournalError, match="missing run_start"):
        journal.SearchJournal.resume(d)
    journal.SearchJournal.start(d, config=dict(CONFIG))
    before = _journal_files(d)
    ro = journal.SearchJournal.resume(d, readonly=True)
    assert not ro.writable
    rec = ro.append("iter_done", it=0)
    assert rec["seq"] == 1 and ro.seq == 1
    assert _journal_files(d) == before


def test_journal_append_site_fires_after_the_record_is_durable(tmp_path):
    d = str(tmp_path)
    j = journal.SearchJournal.start(d, config=dict(CONFIG))
    faults.arm("journal.append", "raise", "1")
    with pytest.raises(faults.InjectedFault):
        j.append("iter_done", it=0)
    assert [r["type"] for r in journal.SearchJournal.load_records(d)] == [
        "run_start", "iter_done"]


# -- PRNG position -----------------------------------------------------------


@pytest.mark.parametrize("draws", [0, 1, 255, 256, 300])
def test_rng_snapshot_matches_the_jax_context(draws):
    j = jctx.SearchContext(jctx.Options(seed=5, lut_graph=True))
    t = tctx.SearchContext(tctx.Options(seed=5, lut_graph=True, device="cpu"))
    for c in (j, t):
        for _ in range(draws):
            c.next_seed()
        c.rng.integers(0, 256)
    snap = t.rng_snapshot()
    assert json.dumps(snap, sort_keys=True) == json.dumps(
        j.rng_snapshot(), sort_keys=True)
    # Either snapshot restores the other context to the same next draws.
    t2 = tctx.SearchContext(tctx.Options(seed=99, device="cpu"))
    t2.rng_restore(json.loads(json.dumps(j.rng_snapshot())))
    j.rng_restore(json.loads(json.dumps(snap)))
    a = [t2.next_seed() for _ in range(300)] + [int(t2.rng.integers(0, 2**63))]
    b = [j.next_seed() for _ in range(300)] + [int(j.rng.integers(0, 2**63))]
    assert a == b


# -- chunk prefetcher --------------------------------------------------------


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("n,k,chunk,excl", [(12, 5, 100, [3, 7]),
                                            (20, 3, 64, []),
                                            (9, 7, 8, [0])])
def test_prefetcher_yields_the_jax_packages_chunks(depth, n, k, chunk, excl):
    def chunks(mod):
        out = []
        with mod.ChunkPrefetcher(mod.CombinationStream(n, k), chunk, excl,
                                 depth=depth) as pf:
            while (item := pf.get()) is not None:
                out.append((item[0].tolist(), item[1]))
            assert pf.get() is None
        return out

    got = chunks(comb)
    assert got == chunks(jcomb)
    assert sum(v for _, v in got) == sum(
        1 for c in itertools.combinations(range(n), k)
        if not set(c) & set(excl))


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_prefetcher_raises_a_producer_fault_at_its_chunk(depth):
    def run(mod, fmod):
        fmod.arm("prefetch.produce", "raise", "3")
        seen = 0
        with pytest.raises(fmod.InjectedFault):
            with mod.ChunkPrefetcher(mod.CombinationStream(10, 5), 50, [],
                                     depth=depth) as pf:
                while pf.get() is not None:
                    seen += 1
        fmod.disarm()
        return seen

    assert run(comb, faults) == run(jcomb, jfaults) == 2


def test_prefetcher_close_stops_the_worker():
    pf = comb.ChunkPrefetcher(comb.CombinationStream(30, 5), 16, [], depth=2)
    assert pf.get() is not None
    pf.close()
    pf.close()
    assert pf.closed and pf.get() is None


def test_combination_rank_inverts_unranking():
    for r in (0, 1, 17, 5000, comb.n_choose_k(20, 5) - 1):
        c = comb.unrank_combination(r, 20, 5)
        assert comb.combination_rank(c, 20) == r == jcomb.combination_rank(c, 20)
    rows = np.array([[0, 1, 2], [1, 4, 5], [2, 3, 9]], np.int32)
    np.testing.assert_array_equal(comb.filter_exclude(rows, [4]),
                                  jcomb.filter_exclude(rows, [4]))
