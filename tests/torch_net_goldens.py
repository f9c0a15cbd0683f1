"""Goldens of the HTTP admission front door (``serve_net/``), written by the
JAX package, and the request sequences both packages are driven with.

Each case of ``CASES`` is a fixed sequence of HTTP requests to an
``AdmissionServer`` on an ephemeral loopback port:

- a ``stack`` case builds the context, the serve orchestrator and the
  admission server in one process (:func:`make_stack`, for either
  package), posts its requests, starts the orchestrator where the
  sequence says so (jobs posted before that form one admission round:
  a merged wave), and long-polls every job to its end;
- a ``cli`` case runs the package's CLI with ``--serve-port 0`` in a
  fresh process (:func:`start_cli`), reads the bound port from its
  ``serve-net: admission endpoint`` line, posts, long-polls and ends it
  with SIGTERM.

The golden of a case, under ``tests/data/torch_golden/net/<case>/``, is
``responses.json`` (the status and JSON body of every response; of a
fresh POST to a running CLI only the status and job id, since its state
is "queued" or "running" by timing), the admission journal, ``_net/`` and
every ``net-*`` job directory's XML files and journals, with the run
directory written ``@RUN@`` and the checkout root ``@ROOT@``.
:func:`compare_net` holds a run against it: the journal's admit records in
order and its done markers as a set (the order jobs of several lanes
finish in is the scheduler's), every other file byte for byte.

Before it copies, the writer waits (bounded) until the admission journal
has nothing pending: the JAX package appends a job's done marker after
the long-poll that sees it finished may already have returned.  From the
root of a checkout, with the JAX package's requirements:

    python tests/torch_net_goldens.py [case ...]

(seconds each on the CPU, one fresh process per case).
"""

import http.client
import importlib
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NET = os.path.join(ROOT, "tests", "data", "torch_golden", "net")
ROUNDS = os.path.join(ROOT, "tests", "data", "torch_golden", "rounds")
ROOT_MARK = "@ROOT@"
RUN_MARK = "@RUN@"
PKGS = {"jax": "sboxgates_tpu", "torch": "sboxgates_tpu_torch"}
ADMIT_JOURNAL = "admission.journal.jsonl"

#: The tenants of every case (the token file both packages write).
TENANTS = {
    "acme": {"token": "tok-acme", "max_jobs": 16, "rate_per_s": 500.0,
             "burst": 400},
    "blue": {"token": "tok-blue", "max_jobs": 16, "rate_per_s": 500.0,
             "burst": 400},
}
TOKENS = {name: row["token"] for name, row in TENANTS.items()}
#: The rejection checks' tenants: a rate of one request, a quota of one
#: job, a disabled tenant.
REJECT_TENANTS = dict(TENANTS, **{
    "slow": {"token": "tok-slow", "rate_per_s": 0.001, "burst": 1},
    "one": {"token": "tok-one", "max_jobs": 1, "rate_per_s": 500.0,
            "burst": 200},
    "off": {"token": "tok-off", "disabled": True},
})

DES = [os.path.join(ROOT, "sboxes", f"des_s{i}.txt") for i in range(1, 9)]
PLANTED8 = [os.path.join(ROUNDS, f"planted_chain_{i}.txt") for i in range(8)]


def toy_values(j: int):
    """The j-th toy 3-input table of ``search/fleet.py: toy_fleet_boxes``
    (parity and majority variants), computed here without either
    package."""
    out = []
    for i in range(8):
        x0, x1, x2 = i & 1, (i >> 1) & 1, (i >> 2) & 1
        bits = (x0 ^ x1 ^ x2 ^ (j & 1)) | (
            (int(x0 + x1 + x2 >= 2) ^ ((j >> 1) & 1)) << 1)
        out.append(bits ^ ((j >> 2) & 1))
    return out


def sbox_text(box) -> str:
    """The POST's ``sbox`` text: ``("toy", j, style)`` (style 0 lowercase
    on one line, 1 uppercase four to a line) or ``("file", path)``."""
    if box[0] == "toy":
        vals = toy_values(box[1])
        if box[2] == 0:
            return " ".join("%02x" % v for v in vals)
        return "\n".join(" ".join("%02X" % v for v in vals[r:r + 4])
                         for r in range(0, len(vals), 4)) + "\n"
    with open(box[1], "r", encoding="utf-8") as f:
        return f.read()


def _post(tenant, box, idem=None, full=True, **extra):
    return ("post", tenant, box, extra, idem, full)


#: case -> spec.  ``steps``: ("post", tenant, box, body extras,
#: Idempotency-Key, record the whole body), ("start",) (a stack case's
#: orchestrator), ("poll", i) (long-poll the job of the i-th POST to its
#: end), ("poll_id", job id).  A stack case has ``opts`` (the Options both
#: packages share), ``route`` ("dev": every node on the device sweeps) and
#: ``lanes``; a cli case ``argv`` (without the port, token file and output
#: directory) and its environment.
CASES = {
    # Toy 3-input boxes on the device route, one lane (jobs finish in
    # admission order): a POST, its repeat on the same key, another
    # tenant's POST of the same query in other formatting (both joined),
    # an all-outputs query and a permuted one, then long-polls and
    # repeats of finished queries (200 with circuits).
    "net_toy": {
        "kind": "stack", "lanes": 1, "route": "dev",
        "opts": {"lut_graph": True, "randomize": False, "seed": 11},
        "steps": [
            _post("acme", ("toy", 0, 0), "k1", output=0),
            _post("acme", ("toy", 0, 0), "k1", output=0),
            _post("blue", ("toy", 0, 1), "k1", output=0),
            _post("acme", ("toy", 1, 0), None, output=-1),
            _post("blue", ("toy", 2, 0), None, output=0, permute=3),
            ("start",),
            ("poll", 0), ("poll", 3), ("poll", 4),
            _post("acme", ("toy", 0, 1), "k1", output=0),
            _post("blue", ("toy", 1, 1), None, output=-1),
            _post("acme", ("toy", 2, 0), None, output=0, permute=3),
        ],
    },
    # The eight planted-chain boxes, chained (-l --chain-rounds 8), on the
    # device route, all admitted before the orchestrator starts: one
    # merged wave of eight lanes (K3's lane form on a card).
    "net_chain8_dev": {
        "kind": "stack", "lanes": 8, "route": "dev",
        "opts": {"lut_graph": True, "seed": 1, "chain_rounds": 8,
                 "serial_mux": True},
        "steps": [_post("acme" if i % 2 == 0 else "blue", ("file", p))
                  for i, p in enumerate(PLANTED8)]
        + [("start",)] + [("poll", i) for i in range(8)]
        + [_post("acme", ("file", p)) for p in PLANTED8[:2]],
    },
    # DES S1-S8, output 0, through the CLI on the default route.  DES S1
    # is also the CLI's positional input (the CLI needs one): its job is
    # job00-des_s1.
    "net_des8_o0": {
        "kind": "cli", "env": {},
        "argv": ["-o", "0", "--serve", "--serve-lanes", "8",
                 "--metrics-interval", "0.05", "--seed", "1", DES[0]],
        "steps": [_post("acme", ("file", p), full=False, output=0)
                  for p in DES]
        + [("poll", i) for i in range(8)]
        + [_post("blue", ("file", DES[0]), output=0)],
    },
}


def golden_dir(case: str) -> str:
    return os.path.join(NET, case)


# -- HTTP --------------------------------------------------------------------


def request(port, method, path, body=None, token=None, idem=None,
            timeout=60):
    """One HTTP round trip; (status, parsed JSON body)."""
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    headers = {}
    if token is not None:
        headers["Authorization"] = f"Bearer {token}"
    if idem is not None:
        headers["Idempotency-Key"] = idem
    data = json.dumps(body) if isinstance(body, dict) else body
    try:
        c.request(method, path, body=data, headers=headers)
        r = c.getresponse()
        return r.status, json.loads(r.read().decode("utf-8"))
    finally:
        c.close()


def poll(port, job_id, token=TOKENS["acme"], limit_s=300.0):
    """Long-polls a job (``?wait=30``, the server's ceiling) until it is
    done or quarantined; the terminal response."""
    deadline = time.monotonic() + limit_s
    while True:
        s, d = request(port, "GET", f"/v1/jobs/{job_id}?wait=30",
                       token=token)
        if s != 200 or d.get("state") in ("done", "quarantined"):
            return s, d
        if time.monotonic() > deadline:
            raise AssertionError(f"job {job_id} not finished in {limit_s} s")


def drive(port, steps, orch=None, times=None):
    """Runs a case's steps against the server on ``port``; the recorded
    responses and the job id of every POST in order.  ``times``, a list,
    gets (step kind, start, end) of every step (``time.perf_counter``)."""
    out, ids = [], []
    for step in steps:
        t0 = time.perf_counter()
        if step[0] == "start":
            orch.start()
        elif step[0] in ("poll", "poll_id"):
            jid = ids[step[1]] if step[0] == "poll" else step[1]
            s, d = poll(port, jid)
            out.append({"status": s, "body": d})
        else:
            _, tenant, box, extra, idem, full = step
            s, d = request(port, "POST", "/v1/jobs",
                           {"sbox": sbox_text(box), **extra},
                           token=TOKENS[tenant], idem=idem)
            ids.append(d.get("job_id"))
            out.append({"status": s, "body": d} if full
                       else {"status": s, "job_id": d.get("job_id")})
        if times is not None:
            times.append((step[0], t0, time.perf_counter()))
    return out, ids


# -- the stack (in process) --------------------------------------------------


def write_tokens(pkg: str, path: str) -> str:
    net = importlib.import_module(PKGS[pkg] + ".serve_net")
    net.write_token_file(path, TENANTS)
    return path


def build_stack(pkg: str, root: str, opts: dict, route: str, lanes: int,
                device: str = "cpu", tenants=TENANTS,
                read_timeout_s: float = 10.0):
    """(ctx, orchestrator, admission server) for ``pkg`` ("jax" or
    "torch"; the port's context on ``device``), none started: ``opts``
    the Options both packages share (``serial_mux`` for
    ``parallel_mux=False``), ``route`` "dev" for every node on the device
    sweeps, the token file ``root + ".tokens"`` over ``tenants``."""
    mod = PKGS[pkg]
    search = importlib.import_module(mod + ".search")
    serve = importlib.import_module(mod + ".search.serve")
    deadline = importlib.import_module(mod + ".resilience.deadline")
    net = importlib.import_module(mod + ".serve_net")
    server = importlib.import_module(mod + ".serve_net.server")
    opts = dict(opts)
    if opts.pop("serial_mux", False):
        opts["parallel_mux"] = False
    if pkg == "jax":
        opts["warmup"] = False
        if route == "dev":
            opts.update(native_engine=False, host_small_steps=False)
    else:
        opts["device"] = device
        if route == "dev":
            opts["native"] = False
    ctx = search.SearchContext(search.Options(**opts))
    orch = serve.ServeOrchestrator(
        ctx, root, lanes=lanes,
        deadline=deadline.DeadlineConfig(retries=2, backoff_s=0.01),
        log=lambda s: None,
    )
    tok = root + ".tokens"
    net.write_token_file(tok, tenants)
    srv = server.AdmissionServer(orch, net.TokenStore.load(tok), ctx.stats,
                                 root, read_timeout_s=read_timeout_s,
                                 log=lambda s: None)
    return ctx, orch, srv


def make_stack(pkg: str, case: str, root: str, device: str = "cpu"):
    """:func:`build_stack` of a stack case."""
    spec = CASES[case]
    return build_stack(pkg, root, spec["opts"], spec["route"], spec["lanes"],
                       device)


def pending(pkg: str, root: str):
    adm = importlib.import_module(PKGS[pkg] + ".serve_net.admission")
    return adm.pending_jobs(root)


def settle(pkg: str, root: str, limit_s: float = 30.0):
    """Waits (bounded) until the admission journal has nothing pending;
    the pending job ids left."""
    deadline = time.monotonic() + limit_s
    while pending(pkg, root) and time.monotonic() < deadline:
        time.sleep(0.05)
    return pending(pkg, root)


def run_stack(pkg: str, case: str, root: str, device: str = "cpu"):
    """A stack case end to end: (responses, job ids, ctx, orchestrator);
    the server closed and the orchestrator stopped."""
    ctx, orch, srv = make_stack(pkg, case, root, device)
    srv.start()
    try:
        out, ids = drive(srv.port, CASES[case]["steps"], orch)
        left = settle(pkg, root)
        if left:
            raise AssertionError(f"{case}: jobs {left} still pending")
    finally:
        srv.close()
        orch.run_until_idle(timeout_s=120)
        orch.stop()
    return out, ids, ctx, orch


# -- the CLI (fresh process) -------------------------------------------------


def cli_argv(case: str, tokens: str, outdir: str):
    return [*CASES[case]["argv"], "--serve-port", "0", "--serve-token-file",
            tokens, "--output-dir", outdir]


def start_cli(cmd, argv, cwd, env, limit_s=300.0):
    """Starts ``cmd + argv`` and reads its output up to the admission
    endpoint's line: (process, bound port, lines read).  Raises (after
    killing it) if the process ends or does not open the endpoint in
    ``limit_s``."""
    proc = subprocess.Popen(
        [*cmd, *argv], cwd=cwd, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
    )
    lines = []
    deadline = time.monotonic() + limit_s
    for line in proc.stdout:
        lines.append(line)
        if line.startswith("serve-net: admission endpoint on "):
            url = line.split(" on ", 1)[1].strip()
            return proc, int(url.rsplit(":", 1)[1].split("/", 1)[0]), lines
        if time.monotonic() > deadline:
            break
    proc.kill()
    rest = proc.communicate()[0] or ""
    raise AssertionError(f"{cmd} {argv} exited {proc.returncode} before its "
                         f"admission endpoint:\n{''.join(lines) + rest}")


def stop_cli(proc, limit_s=60.0):
    """SIGTERM (the serve's drain) and the rest of the output: (exit code,
    output)."""
    proc.send_signal(signal.SIGTERM)
    try:
        rest = proc.communicate(timeout=limit_s)[0] or ""
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return proc.returncode, rest


def cli_env(extra=None):
    env = dict(os.environ, PYTHONPATH=ROOT, PYTHONUNBUFFERED="1",
               JAX_PLATFORMS="cpu", SBG_WARMUP="0")
    for k in ("SBG_DISABLE_NATIVE", "SBG_FAULTS", "SBG_ENGINE_MUX_THREADS",
              "SBG_RESULT_STORE", "SBG_SERVE_NO_MERGE"):
        env.pop(k, None)
    env.update(extra or {})
    return env


def run_cli(pkg: str, cmd, case: str, cwd: str, env):
    """A cli case end to end from ``cwd`` with ``pkg``'s CLI ``cmd`` (token
    file ``tokens.json``, output directory ``D``): (exit code, responses,
    job ids, output)."""
    tok = write_tokens(pkg, os.path.join(cwd, "tokens.json"))
    proc, port, lines = start_cli(cmd, cli_argv(case, tok, "D"), cwd, env)
    try:
        out, ids = drive(port, CASES[case]["steps"])
        left = settle(pkg, os.path.join(cwd, "D"))
        if left:
            raise AssertionError(f"{case}: jobs {left} still pending")
    finally:
        rc, rest = stop_cli(proc)
    return rc, out, ids, "".join(lines) + rest


def crash_and_replay(pkg: str, cmd, cwd: str, env):
    """The crash window through ``pkg``'s CLI ``cmd`` from ``cwd``, with
    net_des8_o0's command: armed with ``net.admit_journal:crash@2`` (the
    positional input's done marker is the run's first record, so the
    POST's admit record is the second) the CLI dies with exit 17 after
    the admit record of DES S1's POST is durable and before the job is
    queued; the same command without the fault replays it and serves it
    to its end; SIGTERM.  Returns (the first run's exit code, the job ids
    pending after it, the second run's exit code, its output)."""
    tok = write_tokens(pkg, os.path.join(cwd, "tokens.json"))
    argv = cli_argv("net_des8_o0", tok, "D")
    d = os.path.join(cwd, "D")
    proc, port, _ = start_cli(
        cmd, argv, cwd, dict(env, SBG_FAULTS="net.admit_journal:crash@2"))
    try:
        s, doc = poll(port, "job00-des_s1")
        if s != 200 or doc["state"] != "done":
            raise AssertionError(f"job00-des_s1: {s} {doc}")
        try:
            request(port, "POST", "/v1/jobs",
                    {"sbox": sbox_text(("file", DES[0])), "output": 0},
                    token=TOKENS["acme"])
        except OSError:
            pass  # the process died under the request
        rc1 = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()
    left = pending(pkg, d)
    proc, port, lines = start_cli(cmd, argv, cwd, env)
    try:
        for jid in left:
            poll(port, jid)
    finally:
        rc2, rest = stop_cli(proc)
    return rc1, left, rc2, "".join(lines) + rest


def rerun_replays_nothing(pkg: str, cmd, cwd: str, env, job_id: str):
    """net_des8_o0's command again in ``cwd`` after a finished run: the
    output, and the answer to a GET of one of the earlier run's jobs (404:
    nothing was replayed)."""
    tok = os.path.join(cwd, "tokens.json")
    proc, port, lines = start_cli(cmd, cli_argv("net_des8_o0", tok, "D"),
                                  cwd, env)
    try:
        answer = request(port, "GET", f"/v1/jobs/{job_id}",
                         token=TOKENS["acme"])
    finally:
        rc, rest = stop_cli(proc)
    return rc, answer, "".join(lines) + rest


def raw_request(port, data: bytes):
    """A request written to the socket as given (a missing or bad
    Content-Length, a stalled body); (status, parsed JSON body)."""
    import socket

    c = socket.create_connection(("127.0.0.1", port), timeout=30)
    try:
        c.sendall(data)
        got = b""
        while True:
            chunk = c.recv(65536)
            if not chunk:
                break
            got += chunk
    finally:
        c.close()
    head, _, body = got.partition(b"\r\n\r\n")
    return int(head.split(b" ", 2)[1]), json.loads(body.decode("utf-8"))


# -- the files ---------------------------------------------------------------


def net_files(d: str):
    """{relative path: bytes} of a run directory's front-door files: the
    admission journal, ``_net/`` (flight dumps aside) and every ``net-*``
    job directory's XML files and journals, the run directory written
    ``@RUN@`` and the checkout root ``@ROOT@``."""
    run = os.path.abspath(d)
    out = {}
    for base, dirs, files in os.walk(d):
        rel_base = os.path.relpath(base, d)
        top = rel_base.split(os.sep)[0]
        dirs[:] = sorted(x for x in dirs if rel_base != "." or x == "_net"
                         or x.startswith("net-"))
        for f in files:
            rel = os.path.normpath(os.path.join(rel_base, f))
            if rel_base == ".":
                if f != ADMIT_JOURNAL:
                    continue
            elif top == "_net":
                if not f.startswith("sbox-"):
                    continue
            elif not (f.endswith(".xml") or f.startswith("search.journal")):
                continue
            with open(os.path.join(base, f), "rb") as fh:
                data = fh.read()
            if "journal" in f:
                data = data.replace(run.encode(), RUN_MARK.encode())
                data = data.replace(ROOT.encode(), ROOT_MARK.encode())
            out[rel] = data
    return out


def admission_view(data: bytes):
    """The admission journal as the comparison reads it: every record's
    ``seq`` in order from 0, the admit records (seq aside) in order, the
    done markers (seq aside) sorted."""
    lines = [ln for ln in data.decode("utf-8").splitlines() if ln.strip()]
    seqs = [json.loads(ln)["seq"] for ln in lines]
    if seqs != list(range(len(lines))):
        raise AssertionError(f"admission journal seqs {seqs}")
    strip = [json.dumps({k: v for k, v in json.loads(ln).items()
                         if k != "seq"}, sort_keys=True) for ln in lines]
    admits = [s for s in strip if '"type": "admit"' in s]
    dones = sorted(s for s in strip if '"type": "done"' in s)
    return admits, dones


def load_golden(case: str):
    """(responses, {relative path: bytes}) of a case's golden."""
    g = golden_dir(case)
    with open(os.path.join(g, "responses.json"), encoding="utf-8") as f:
        responses = json.load(f)
    files = {}
    for base, _, names in os.walk(g):
        for f in names:
            p = os.path.join(base, f)
            rel = os.path.relpath(p, g)
            if rel != "responses.json":
                with open(p, "rb") as fh:
                    files[rel] = fh.read()
    return responses, files


def compare_net(case: str, d: str, responses=None, only=None):
    """Holds the run directory ``d`` (and its ``responses``) against the
    case's golden; ``only``: the job ids whose directories (and nothing
    else) are compared."""
    want_resp, want = load_golden(case)
    got = net_files(d)
    if only is not None:
        keep = lambda rel: rel.split(os.sep)[0] in only  # noqa: E731
        want = {k: v for k, v in want.items() if keep(k)}
        got = {k: v for k, v in got.items() if keep(k)}
    if sorted(got) != sorted(want):
        raise AssertionError(f"{case}: files {sorted(got)} != {sorted(want)}")
    for rel in want:
        if rel == ADMIT_JOURNAL:
            if admission_view(got[rel]) != admission_view(want[rel]):
                raise AssertionError(f"{case}: the admission journal differs:"
                                     f"\n{got[rel]!r}\n{want[rel]!r}")
        elif got[rel] != want[rel]:
            raise AssertionError(f"{case}: {rel} differs from the golden")
    if responses is not None and responses != want_resp:
        for i, (a, b) in enumerate(zip(responses, want_resp)):
            if a != b:
                raise AssertionError(f"{case}: response {i} {a} != {b}")
        raise AssertionError(f"{case}: {len(responses)} responses, "
                             f"golden {len(want_resp)}")


# -- the writer --------------------------------------------------------------


def _save(case: str, d: str, responses) -> None:
    out = golden_dir(case)
    shutil.rmtree(out, ignore_errors=True)
    files = net_files(d)
    for rel, data in files.items():
        p = os.path.join(out, rel)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "wb") as f:
            f.write(data)
    with open(os.path.join(out, "responses.json"), "w",
              encoding="utf-8") as f:
        f.write(json.dumps(responses, sort_keys=True, indent=1) + "\n")
    print(f"{case}: {len(files)} files, {len(responses)} responses",
          flush=True)


def _child(case: str, scratch: str) -> int:
    """One stack case on the JAX package in this (fresh) process."""
    root = os.path.join(scratch, "serve")
    out, _, _, _ = run_stack("jax", case, root)
    _save(case, root, out)
    return 0


def write_golden(case: str, scratch: str) -> None:
    spec = CASES[case]
    cwd = os.path.join(scratch, case)
    os.makedirs(cwd)
    env = cli_env({"SBG_DISABLE_NATIVE": "1"} if spec.get("route") == "dev"
                  else spec.get("env"))
    if spec["kind"] == "stack":
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", case, cwd], env=env)
        if r.returncode != 0:
            raise SystemExit(f"{case}: the JAX stack exited {r.returncode}")
        return
    rc, out, _, text = run_cli("jax", [sys.executable, "-m", PKGS["jax"]],
                               case, cwd, env)
    if rc != -signal.SIGTERM:
        raise SystemExit(f"{case}: the JAX CLI exited {rc}:\n{text}")
    _save(case, os.path.join(cwd, "D"), out)


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        return _child(argv[1], argv[2])
    scratch = tempfile.mkdtemp(prefix="sbg-net-goldens-")
    try:
        for case in argv or sorted(CASES):
            write_golden(case, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main(sys.argv[1:]))
