"""The port's HTTP admission front door (``sboxgates_tpu_torch/serve_net/``)
against the JAX package's, through real sockets on ephemeral loopback
ports.

- the token file: the same fail-closed refusals, with the same messages,
  and the same authentication and token-bucket answers;
- the rejection matrix: the same request to a JAX and a port admission
  server gets the same status, code and message, and touches neither the
  orchestrator, the admission journal nor the breaker;
- ``net_toy`` held against the JAX package's golden
  (``tests/torch_net_goldens.py``): every response, the admission journal,
  ``_net/`` and the job files, byte for byte;
- concurrent duplicate POSTs, the four ``net.*`` fault sites, the admit
  journal's fault retried on its Idempotency-Key, a drain then a restart,
  each on both packages;
- the CLI: ``--serve-port`` serving the DES boxes as the JAX CLI does
  (the golden ``net_des8_o0``), a crash between the admit record and the
  enqueue replayed by the next boot, and its flag rejections against the
  JAX CLI's lines;
- the serve's terminal observer returns before ``run_until_idle`` does.

Tolerance: exact equality (bytes, statuses, messages).
"""

import json
import os
import signal
import socket
import sys
import threading
import time

import pytest
import torch

from sboxgates_tpu_torch.resilience import faults
from sboxgates_tpu_torch.search import Options, SearchContext
from sboxgates_tpu_torch.search.serve import ServeJob, ServeOrchestrator

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_net_goldens as g  # noqa: E402

torch.set_num_threads(1)

PKGS = ("jax", "torch")


def _faults(pkg):
    import importlib

    return importlib.import_module(g.PKGS[pkg] + ".resilience.faults")


@pytest.fixture(autouse=True)
def _clean_process_state():
    """Disarmed faults around every test, and after it the flight
    recorders reset: a 5xx's dump numbers the process's dumps, which a
    later test in the same process counts from 1."""
    import importlib

    for pkg in PKGS:
        _faults(pkg).disarm()
    yield
    for pkg in PKGS:
        _faults(pkg).disarm()
        importlib.import_module(
            g.PKGS[pkg] + ".telemetry.flight").flight_recorder().reset()


def _net(pkg):
    import importlib

    return importlib.import_module(g.PKGS[pkg] + ".serve_net")


# -- the token file -------------------------------------------------------------

BAD_DOCS = {
    "torn_json": "{torn",
    "version": json.dumps({"version": 99, "tenants": {}}),
    "no_tenants": json.dumps({"version": 1, "tenants": {}}),
    "no_token": json.dumps({"version": 1, "tenants": {"a": {}}}),
    "zero_quota": json.dumps({"version": 1,
                              "tenants": {"a": {"token": "t", "max_jobs": 0}}}),
    "truncated": json.dumps({"version": 1,
                             "tenants": {"a": {"token": "t"}}})[:-7],
}


@pytest.mark.parametrize("case", sorted(BAD_DOCS) + ["world_writable",
                                                      "missing"])
def test_token_file_is_refused_as_the_jax_package_refuses_it(case, tmp_path):
    path = str(tmp_path / "tokens.json")
    if case in BAD_DOCS:
        with open(path, "w") as f:
            f.write(BAD_DOCS[case])
        os.chmod(path, 0o600)
    elif case == "world_writable":
        _net("torch").write_token_file(path, {"a": {"token": "t"}})
        os.chmod(path, 0o606)
    msgs = []
    for pkg in PKGS:
        net = _net(pkg)
        with pytest.raises(net.TokenFileError) as e:
            net.TokenStore.load(path)
        msgs.append(str(e.value))
        if case in ("world_writable", "missing"):
            assert net.check_file(path) == str(e.value)
    assert msgs[0] == msgs[1] and msgs[0].startswith(f"token file {path}: ")
    if case == "world_writable":
        assert "world-writable" in msgs[0]


def test_token_store_answers_as_the_jax_package(tmp_path):
    path = str(tmp_path / "tokens.json")
    tenants = {"a": {"token": "ta", "rate_per_s": 2.0, "burst": 2},
               "b": {"token": "tb"}, "off": {"token": "to", "disabled": True}}
    answers = []
    for pkg in PKGS:
        net = _net(pkg)
        net.write_token_file(path, tenants)
        assert (os.stat(path).st_mode & 0o777) == 0o600
        assert net.check_file(path) is None
        store = net.TokenStore.load(path)
        got = [store.authenticate("Bearer ta").name,
               store.authenticate("Bearer tb ").name]
        for header in (None, "Basic ta", "Bearer nope", "Bearer to"):
            with pytest.raises(net.AuthError) as e:
                store.authenticate(header)
            got.append((e.value.status, e.value.code, str(e.value)))
        got.append([store.allow("a", now=t)
                    for t in (0.0, 0.0, 0.1, 0.4, 0.5, 5.0, 5.0, 5.0)])
        got.append(store.allow("nobody", now=0.0))
        got.append(sorted((t.name, t.max_jobs, t.rate_per_s, t.burst,
                           t.disabled) for t in store.tenants.values()))
        answers.append(got)
    assert answers[0] == answers[1]
    assert answers[1][2][0] == 401 and answers[1][5][0] == 403


# -- the rejection matrix -----------------------------------------------------------

REJECT_TENANTS = g.REJECT_TENANTS


#: The toy stacks' options: LUT mode, every node on the device sweeps.
TOY_OPTS = {"lut_graph": True, "randomize": False, "seed": 11}


def _stack(pkg, root, tenants=g.TENANTS, read_timeout_s=10.0, lanes=2):
    """A toy stack of ``pkg`` over ``tenants`` (none started)."""
    return g.build_stack(pkg, root, TOY_OPTS, "dev", lanes, "cpu", tenants,
                         read_timeout_s)


@pytest.fixture(scope="module")
def reject_stacks(tmp_path_factory):
    d = tmp_path_factory.mktemp("reject")
    stacks = {pkg: _stack(pkg, str(d / pkg), REJECT_TENANTS, read_timeout_s=1.0)
              for pkg in PKGS}
    for _, _, srv in stacks.values():
        srv.start()
    yield stacks
    for _, _, srv in stacks.values():
        srv.close()


_raw = g.raw_request


TOY = g.toy_values(0)
TOY_TEXT = " ".join("%02x" % v for v in TOY)


def _post_raw(port, body: str, length=None, token="tok-acme", stall=False):
    hdr = (f"POST /v1/jobs HTTP/1.1\r\nHost: t\r\nConnection: close\r\n"
           f"Authorization: Bearer {token}\r\n")
    if length is not None:
        hdr += f"Content-Length: {length}\r\n"
    return _raw(port, (hdr + "\r\n" + body).encode())


def _req(port, method, path, body=None, token="tok-acme", idem=None):
    return g.request(port, method, path, body, token=token, idem=idem)


def _quota_setup(p):
    """The quota case's tenant takes its one job (admitted, not run)."""
    s, _ = _req(p, "POST", "/v1/jobs", {"sbox": TOY_TEXT, "output": 0},
                token="tok-one")
    assert s == 202


#: case -> (set-up or None, the request (a function of the port), its
#: status and code, the counter it adds one to or None).
REJECTS = {
    "401_missing": (None, lambda p: _req(p, "POST", "/v1/jobs", {"sbox": "x"},
                                         token=None),
                    401, "unauthorized", "net_rejected_auth"),
    "401_unknown": (None, lambda p: _req(p, "POST", "/v1/jobs",
                                         {"sbox": TOY_TEXT}, token="wrong"),
                    401, "unauthorized", "net_rejected_auth"),
    "403_disabled": (None, lambda p: _req(p, "POST", "/v1/jobs",
                                          {"sbox": TOY_TEXT}, token="tok-off"),
                     403, "forbidden", "net_rejected_auth"),
    "411_no_length": (None, lambda p: _post_raw(p, ""), 411, "length_required",
                      None),
    "400_bad_length": (None, lambda p: _post_raw(p, "{}", length="abc"), 400,
                       "bad_request", None),
    "400_negative_length": (None, lambda p: _post_raw(p, "{}", length=-4), 400,
                            "bad_request", None),
    "413_oversize": (None, lambda p: _req(p, "POST", "/v1/jobs",
                                          "x" * (65 * 1024)),
                     413, "payload_too_large", "net_oversize"),
    "408_stalled_body": (None, lambda p: _raw(p, (
        "POST /v1/jobs HTTP/1.1\r\nHost: t\r\nAuthorization: Bearer tok-acme"
        "\r\nContent-Length: 500\r\n\r\npartial").encode()),
        408, "request_timeout", "net_timeouts"),
    "400_bad_json": (None, lambda p: _req(p, "POST", "/v1/jobs", "{not json"),
                     400, "bad_request", None),
    "400_not_object": (None, lambda p: _req(p, "POST", "/v1/jobs", "[1, 2]"),
                       400, "bad_request", None),
    "400_no_sbox": (None, lambda p: _req(p, "POST", "/v1/jobs", {"output": 0}),
                    400, "bad_request", None),
    "400_bad_sbox": (None, lambda p: _req(p, "POST", "/v1/jobs",
                                          {"sbox": "zz not hex"}),
                     400, "bad_sbox", None),
    "400_output_range": (None, lambda p: _req(p, "POST", "/v1/jobs",
                                              {"sbox": TOY_TEXT, "output": 8}),
                         400, "bad_request", None),
    "400_output_type": (None, lambda p: _req(p, "POST", "/v1/jobs",
                                             {"sbox": TOY_TEXT, "output": "x"}),
                        400, "bad_request", None),
    "400_permute_range": (None, lambda p: _req(p, "POST", "/v1/jobs",
                                               {"sbox": TOY_TEXT,
                                                "permute": 8}),
                          400, "bad_request", None),
    "400_metric": (None, lambda p: _req(p, "POST", "/v1/jobs",
                                        {"sbox": TOY_TEXT, "metric": 1}),
                   400, "bad_request", None),
    "404_route": (None, lambda p: _req(p, "GET", "/v1/nope"), 404, "not_found",
                  None),
    "404_job": (None, lambda p: _req(p, "GET", "/v1/jobs/net-ffffffffffffffff"),
                404, "not_found", None),
    "404_bad_job_id": (None, lambda p: _req(p, "GET", "/v1/jobs/a/b"), 404,
                       "not_found", None),
    "400_bad_wait": (None, lambda p: _req(p, "GET", "/v1/jobs/net-0?wait=soon"),
                     400, "bad_request", None),
    "429_rate": (lambda p: _req(p, "GET", "/v1/jobs/net-0", token="tok-slow"),
                 lambda p: _req(p, "GET", "/v1/jobs/net-0", token="tok-slow"),
                 429, "rate_limited", "net_rejected_rate"),
    "429_quota": (_quota_setup,
                  lambda p: _req(p, "POST", "/v1/jobs",
                                 {"sbox": TOY_TEXT, "output": 1},
                                 token="tok-one"),
                  429, "over_quota", "net_rejected_quota"),
}


def _queue(orch):
    view = orch.status_view()
    return view["counts"], sorted(view["jobs"])


@pytest.mark.parametrize("case", sorted(REJECTS))
def test_rejection_is_the_jax_packages_and_touches_nothing(case,
                                                          reject_stacks):
    setup, send, status, code, counter = REJECTS[case]
    answers = []
    for pkg in PKGS:
        ctx, orch, srv = reject_stacks[pkg]
        if setup is not None:
            setup(srv.port)
        before = (_queue(orch),
                  _net(pkg).AdmissionJournal.load(orch.root),
                  int(ctx.stats.get(counter, 0)) if counter else 0)
        s, d = send(srv.port)
        answers.append((s, d))
        assert (s, d["error"]["status"], d["error"]["code"]) == (
            status, status, code), (pkg, d)
        assert _queue(orch) == before[0]
        assert _net(pkg).AdmissionJournal.load(orch.root) == before[1]
        if counter:
            assert int(ctx.stats.get(counter, 0)) == before[2] + 1, counter
        assert int(ctx.stats.get("device_dispatches", 0)) == 0
        assert int(ctx.stats.get("circuit_breaker_trips", 0)) == 0
        assert ctx.stats.undeclared() == set()
    assert answers[0] == answers[1]


# -- the golden ---------------------------------------------------------------------


def test_net_toy_is_the_jax_packages_golden(tmp_path):
    root = str(tmp_path / "serve")
    out, ids, ctx, orch = g.run_stack("torch", "net_toy", root)
    g.compare_net("net_toy", root, out)
    assert g.pending("torch", root) == []
    c = ctx.stats
    assert (c.get("net_requests"), c.get("net_jobs_admitted"),
            c.get("net_joined"), c.get("net_repeat_hits")) == (11, 3, 2, 3)
    assert c.get("net_errors", 0) == 0 and c.undeclared() == set()
    assert orch.job(ids[0]).joined == 2


def test_net_chain8_dev_is_the_jax_packages_golden(tmp_path):
    # The eight chains admitted before the start: one merged wave on the
    # device route (K3's lane form on a card, its plain version here).
    root = str(tmp_path / "serve")
    out, ids, ctx, orch = g.run_stack("torch", "net_chain8_dev", root)
    g.compare_net("net_chain8_dev", root, out)
    assert g.pending("torch", root) == []
    c = ctx.stats
    assert c.get("net_jobs_admitted") == 8 and c.get("net_repeat_hits") == 2
    assert c.get("serve_merged_dispatches", 0) >= 1


# -- one search for N clients; faults; drain and restart ------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_concurrent_duplicate_posts_make_one_search(pkg, tmp_path):
    ctx, orch, srv = _stack(pkg, str(tmp_path / "serve"))
    srv.start()
    orch.start()
    n = 6
    barrier = threading.Barrier(n)
    results = [None] * n

    def client(i):
        barrier.wait()
        results[i] = g.request(srv.port, "POST", "/v1/jobs",
                               {"sbox": g.sbox_text(("toy", 2, i % 2)),
                                "output": 0}, token="tok-acme", idem="dup")

    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert all(r is not None for r in results)
        ids = {d["job_id"] for _, d in results}
        assert len(ids) == 1, results
        jid = ids.pop()
        s, d = g.poll(srv.port, jid)
        assert s == 200 and d["state"] == "done"
        assert int(ctx.stats.get("net_jobs_admitted", 0)) == 1
        joined = int(ctx.stats.get("net_joined", 0))
        assert joined + int(ctx.stats.get("net_repeat_hits", 0)) == n - 1
        assert orch.job(jid).joined == joined
        assert [f for f in os.listdir(orch.root) if f.startswith("net-")] == [jid]
        s2, d2 = g.request(srv.port, "POST", "/v1/jobs",
                           {"sbox": g.sbox_text(("toy", 2, 0)), "output": 0},
                           token="tok-acme", idem="dup")
        assert s2 == 200 and d2["circuits"] == d["circuits"]
        assert g.settle(pkg, orch.root) == []
    finally:
        srv.close()
        orch.run_until_idle(timeout_s=60)
        orch.stop()


@pytest.mark.parametrize("site", ["net.accept", "net.auth", "net.body",
                                  "net.admit_journal"])
def test_fault_site_answers_503_with_a_flight_dump_and_the_server_survives(
        site, tmp_path):
    answers = []
    for pkg in PKGS:
        ctx, orch, srv = _stack(pkg, str(tmp_path / pkg))
        srv.start()
        try:
            _faults(pkg).arm(site, "raise", "1")
            s, d = g.request(srv.port, "POST", "/v1/jobs",
                             {"sbox": TOY_TEXT, "output": 0},
                             token="tok-acme", idem="f")
            _faults(pkg).disarm(site)
            flight = d["error"].pop("flight")
            assert os.path.dirname(flight) == os.path.join(orch.root, "_net")
            assert os.path.exists(flight)
            assert int(ctx.stats.get("net_errors", 0)) == 1
            # The next requests are served: a GET and the retried POST.
            s2, d2 = g.request(srv.port, "GET", "/v1/jobs/net-0",
                               token="tok-acme")
            s3, d3 = g.request(srv.port, "POST", "/v1/jobs",
                               {"sbox": TOY_TEXT, "output": 0},
                               token="tok-acme", idem="f")
            admits = [r["job_id"] for r in
                      _net(pkg).AdmissionJournal.load(orch.root)]
            answers.append((s, d, s2, d2, s3, d3, admits))
        finally:
            srv.close()
    assert answers[0] == answers[1]
    s, d, s2, _, s3, d3, admits = answers[1]
    assert (s, d["error"]["code"], s2, s3) == (503, "unavailable", 404, 202)
    assert "safe to retry on the same Idempotency-Key" in d["error"]["message"]
    # The admit-journal fault fires after the record is durable: the retry
    # on the same key is one job with two admit records.
    want = 2 if site == "net.admit_journal" else 1
    assert admits == [d3["job_id"]] * want


@pytest.mark.parametrize("pkg", PKGS)
def test_admit_journal_fault_retried_on_its_key_is_one_job(pkg, tmp_path):
    ctx, orch, srv = _stack(pkg, str(tmp_path / "serve"))
    srv.start()
    orch.start()
    try:
        _faults(pkg).arm("net.admit_journal", "raise", "1")
        body = {"sbox": TOY_TEXT, "output": 0}
        s, d = g.request(srv.port, "POST", "/v1/jobs", body, token="tok-acme",
                         idem="retry-me")
        assert s == 503 and "retry" in d["error"]["message"]
        _faults(pkg).disarm("net.admit_journal")
        s, d = g.request(srv.port, "POST", "/v1/jobs", body, token="tok-acme",
                         idem="retry-me")
        assert s in (200, 202)
        jid = d["job_id"]
        s, d = g.poll(srv.port, jid)
        assert s == 200 and d["state"] == "done"
        recs = _net(pkg).AdmissionJournal.load(orch.root)
        assert [r["job_id"] for r in recs if r["type"] == "admit"] == [jid, jid]
        assert g.settle(pkg, orch.root) == []
        assert [f for f in os.listdir(orch.root) if f.startswith("net-")] == [jid]
    finally:
        srv.close()
        orch.run_until_idle(timeout_s=60)
        orch.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_drain_then_restart_replays_every_admitted_job(pkg, tmp_path):
    ctx, orch, srv = _stack(pkg, str(tmp_path / "serve"))
    srv.start()
    admitted = set()
    for j in (0, 1):
        s, d = g.request(srv.port, "POST", "/v1/jobs",
                         {"sbox": g.sbox_text(("toy", j, 0)), "output": 1},
                         token="tok-acme", idem=f"d{j}")
        assert s == 202
        admitted.add(d["job_id"])
    port = srv.port
    # The CLI's SIGTERM order: the front door first, then the queue.
    srv.close()
    orch.drain(timeout_s=10.0)
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=2)
    assert set(g.pending(pkg, orch.root)) == admitted
    ctx2, orch2, srv2 = _stack(pkg, str(tmp_path / "serve"))
    assert set(srv2.replay()) == admitted
    srv2.start()
    orch2.start()
    try:
        for jid in sorted(admitted):
            s, d = g.poll(srv2.port, jid)
            assert s == 200 and d["state"] == "done" and d["circuits"], d
        assert g.settle(pkg, orch2.root) == []
        # A third boot has nothing to replay.
        _, orch3, srv3 = _stack(pkg, str(tmp_path / "serve"))
        assert srv3.replay() == []
        srv3.close()
    finally:
        srv2.close()
        orch2.run_until_idle(timeout_s=60)
        orch2.stop()


def test_close_of_a_server_never_started_frees_its_port(tmp_path):
    # The CLI binds the listener before replay and the positional submits;
    # a drain in that window must still close it.
    _, orch, srv = _stack("torch", str(tmp_path / "serve"))
    port = srv.port
    srv.close()
    srv.close()
    with socket.socket() as s:
        s.bind(("127.0.0.1", port))
        s.listen()
    orch.stop()


def test_replay_repairs_an_unmarked_terminal_job(tmp_path):
    """A job terminal in the orchestrator but without its done marker (a
    kill between the two) gets the marker at replay, in both packages."""
    views = []
    for pkg in PKGS:
        ctx, orch, srv = _stack(pkg, str(tmp_path / pkg))
        orch.on_terminal = None
        import importlib

        serve = importlib.import_module(g.PKGS[pkg] + ".search.serve")
        path = os.path.join(orch.root, "toy.txt")
        with open(path, "w") as f:
            f.write(TOY_TEXT)
        job = serve.ServeJob(job_id="net-x", sbox_path=path, output=0,
                             tenant="acme")
        srv.journal.admit(job, key="k", idem="")
        orch.submit(job)
        orch.start()
        orch.run_until_idle(timeout_s=60)
        orch.stop()
        assert g.pending(pkg, orch.root) == ["net-x"]
        assert srv.replay() == []
        assert g.pending(pkg, orch.root) == []
        with open(os.path.join(orch.root, g.ADMIT_JOURNAL), "rb") as f:
            views.append(g.admission_view(f.read()))
    assert views[0] == views[1]


# -- the terminal observer before idle ------------------------------------------


def test_idle_returns_after_the_terminal_observer(tmp_path):
    """An observer that sleeps, then appends: when run_until_idle returns,
    both jobs' records are on disk, every time."""
    box = str(tmp_path / "toy.txt")
    with open(box, "w") as f:
        f.write(TOY_TEXT)
    for rep in range(5):
        ctx = SearchContext(Options(lut_graph=True, randomize=False, seed=11,
                                    device="cpu", native=False))
        root = str(tmp_path / f"serve{rep}")
        orch = ServeOrchestrator(ctx, root, lanes=2, log=lambda s: None)
        marks = os.path.join(root, "marks.txt")

        def observer(job, marks=marks):
            time.sleep(0.3)
            with open(marks, "a") as f:
                f.write(job.job_id + "\n")
                f.flush()
                os.fsync(f.fileno())

        orch.on_terminal = observer
        for i in range(2):
            orch.submit(ServeJob(job_id=f"j{i}", sbox_path=box, output=i))
        orch.start()
        view = orch.run_until_idle(timeout_s=120)
        with open(marks) as f:
            got = sorted(f.read().split())
        orch.stop()
        assert view["counts"]["done"] == 2, (rep, view)
        assert got == ["j0", "j1"], rep


def test_wait_terminal_returns_after_the_done_marker(tmp_path):
    """A long-poll that sees a job finished sees its done marker on disk."""
    ctx, orch, srv = _stack("torch", str(tmp_path / "serve"))
    mark = srv.journal.mark_done

    def slow_mark(job):
        time.sleep(0.3)
        mark(job)

    orch.on_terminal = slow_mark
    srv.start()
    orch.start()
    try:
        s, d = g.request(srv.port, "POST", "/v1/jobs",
                         {"sbox": TOY_TEXT, "output": 0}, token="tok-acme")
        s, d = g.poll(srv.port, d["job_id"])
        assert d["state"] == "done" and g.pending("torch", orch.root) == []
    finally:
        srv.close()
        orch.run_until_idle(timeout_s=60)
        orch.stop()


# -- the CLI ----------------------------------------------------------------------

PORT_CLI = [sys.executable, "-m", "sboxgates_tpu_torch", "--device", "cpu"]


def test_cli_serves_http_as_the_jax_cli_and_replays_nothing_again(tmp_path):
    rc, out, ids, text = g.run_cli("torch", PORT_CLI, "net_des8_o0",
                                   str(tmp_path), g.cli_env())
    assert rc == -signal.SIGTERM, text
    d = str(tmp_path / "D")
    g.compare_net("net_des8_o0", d, out)
    assert g.pending("torch", d) == []
    assert "serve-net: replayed" not in text
    # The same command again: nothing to replay, the files unchanged.
    rc2, (s, doc), text2 = g.rerun_replays_nothing(
        "torch", PORT_CLI, str(tmp_path), g.cli_env(), ids[0])
    assert rc2 == -signal.SIGTERM and s == 404, (text2, doc)
    assert "serve-net: replayed" not in text2
    g.compare_net("net_des8_o0", d, only=set(ids))


def test_crash_between_admit_record_and_enqueue_is_replayed(tmp_path):
    """``net.admit_journal:crash`` kills the CLI after the admit record is
    durable and before the job is queued (exit 17, one pending job); the
    same command replays it, and the job's files are the uninterrupted
    run's (the golden)."""
    d = str(tmp_path / "D")
    rc1, left, rc2, text = g.crash_and_replay("torch", PORT_CLI, str(tmp_path),
                                              g.cli_env())
    assert rc1 == faults.CRASH_EXIT_CODE
    assert len(left) == 1, left
    assert "serve-net: replayed 1 admitted job(s)" in text, text
    assert rc2 == -signal.SIGTERM, text
    assert g.pending("torch", d) == []
    g.compare_net("net_des8_o0", d, only=set(left))


@pytest.fixture
def token_files(tmp_path):
    good = str(tmp_path / "tokens.json")
    _net("torch").write_token_file(good, g.TENANTS)
    ww = str(tmp_path / "ww.json")
    _net("torch").write_token_file(ww, g.TENANTS)
    os.chmod(ww, 0o606)
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as f:
        f.write("{torn")
    os.chmod(bad, 0o600)
    return {"good": good, "ww": ww, "bad": bad,
            "missing": str(tmp_path / "none.json")}


@pytest.mark.parametrize("case", ["no_serve", "token_without_port", "bad_port",
                                  "port_without_token", "missing_token",
                                  "world_writable_token", "corrupt_token",
                                  "port_in_use"])
def test_cli_rejects_as_the_jax_cli(case, tmp_path, token_files, monkeypatch,
                                    capsys):
    from sboxgates_tpu import cli as jcli
    from sboxgates_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    out = ["--output-dir", str(tmp_path / "out")]
    box = g.DES[0]
    held = None
    if case == "port_in_use":
        held = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        held.bind(("127.0.0.1", 0))
        held.listen(1)
    argv = {
        "no_serve": ["--serve-port", "0", "--serve-token-file",
                     token_files["good"], box],
        "token_without_port": ["--serve", "--serve-token-file",
                               token_files["good"], box, *out],
        "bad_port": ["--serve", "--serve-port", "70000", "--serve-token-file",
                     token_files["good"], box, *out],
        "port_without_token": ["--serve", "--serve-port", "0", box, *out],
        "missing_token": ["--serve", "--serve-port", "0", "--serve-token-file",
                          token_files["missing"], box, *out],
        "world_writable_token": ["--serve", "--serve-port", "0",
                                 "--serve-token-file", token_files["ww"], box,
                                 *out],
        "corrupt_token": ["--serve", "--serve-port", "0", "--serve-token-file",
                          token_files["bad"], box, *out],
        "port_in_use": ["--serve", "--serve-port",
                        str(held.getsockname()[1]) if held else "0",
                        "--serve-token-file", token_files["good"], box, *out],
    }[case]
    try:
        assert cli.main([*argv, "--device", "cpu"]) == 1
        err = capsys.readouterr().err.strip()
        assert err.count("\n") == 0 and "Traceback" not in err, err
        assert jcli.main(argv) == 1
        assert capsys.readouterr().err.strip().splitlines()[-1] == err
    finally:
        if held is not None:
            held.close()
    assert not os.path.exists(tmp_path / "out")
    assert not list(tmp_path.glob("search.journal.*"))
