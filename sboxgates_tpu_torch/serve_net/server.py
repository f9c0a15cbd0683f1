"""The network admission service: an authenticated, quota-enforced,
drain-safe HTTP front door for the serve orchestrator.

Built on the StatusServer substrate — stdlib ``http.server``, a daemon
accept thread (:meth:`AdmissionServer._serve`), request logging through
``logging`` only — but THREADING (one stdlib handler thread per
connection), so a long-poll reader can't starve admissions.

Endpoints::

    POST /v1/jobs          submit a query  -> 202 admitted / joined,
                                              200 circuit (repeat/hit)
    GET  /v1/jobs/<id>     job status; ?wait=N long-polls (bounded)
                           until the job is terminal

Admission order (the robustness spine):

1. ``net.accept`` chaos site — an injected raise is a 503 for THIS
   request only, the serve loop keeps going.
2. Authenticate (``net.auth``): bearer token against the durable token
   file — 401 unknown, 403 disabled, constant-time compares.
3. Rate limit: per-tenant token bucket -> 429, before any body read.
4. Bounded body read (``net.body``): missing length -> 411, oversize
   -> 413, a slowloris client -> 408 at the socket read timeout.  One
   counter each; the serve loop can never wedge on one connection.
5. Idempotency: the job id is derived from the result store's canonical
   query key + the client's ``Idempotency-Key`` header.  A repeat of a
   COMPLETED query answers 200 with the circuit and zero device
   dispatches; a repeat of an IN-FLIGHT query joins the existing job
   (202, ``joined`` count) — never a duplicate search.
6. Quota: max active jobs per tenant -> 429 (fresh admissions only).
7. Durable admission (``net.admit_journal``): the admit record is
   fsync'd BEFORE the orchestrator enqueue and BEFORE the 202 — a
   crash in between loses nothing (restart replays the journal); an
   injected journal fault is a 503 the client retries on the same
   idempotency key.

Every 4xx/5xx body is structured (``{"error": {"status", "code",
"message"}}``); 5xx additionally drops a flight-recorder dump.
Shutdown rides the drain path: :meth:`close` stops the listener (new
connections refused) while already-admitted work drains through the
orchestrator — and unfinished jobs re-serve on the next boot via the
admission journal.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlsplit

from ..core import canon as _canon
from ..core import ttable as tt
from ..resilience import faults
from ..resilience.checkpoint import durable_write_text
from ..search.orchestrator import make_targets
from ..search.serve import (
    DONE,
    QUARANTINED,
    RUNNING,
    TERMINAL,
    ServeClosed,
    ServeJob,
)
from ..telemetry import flight as _tflight
from ..utils.sbox import SboxError, num_outputs, parse_sbox, permuted_box
from .admission import AdmissionJournal
from .tokens import AuthError, Tenant, TokenStore

logger = logging.getLogger(__name__)

#: /v1 response schema version.
NET_SCHEMA = 1
#: Default bound on request bodies (an 8-input S-box posts in < 2 KiB).
MAX_BODY_BYTES = 64 * 1024
#: Default per-connection socket read timeout (slowloris bound).
READ_TIMEOUT_S = 10.0
#: Long-poll ceiling: ``?wait=N`` is clamped here (clients re-poll).
MAX_WAIT_S = 30.0
#: Where posted S-box tables land (content-addressed, under the root).
NET_DIR = "_net"


class _HttpError(Exception):
    """A structured early-exit: maps to one 4xx/5xx response."""

    def __init__(self, status: int, code: str, message: str):
        super().__init__(message)
        self.status = int(status)
        self.code = code


def canonical_sbox_text(values) -> str:
    """The canonical on-disk serialization of a posted S-box table
    (lowercase hex, space-separated): byte-identical for every
    formatting of the same table, so the content address — and the
    replayed admission — is stable."""
    return " ".join(f"{int(v):02x}" for v in values) + "\n"


class AdmissionServer:
    """The /v1 admission endpoint; see the module docstring."""

    def __init__(
        self,
        orch,
        tokens: TokenStore,
        registry,
        root: str,
        port: int = 0,
        host: str = "127.0.0.1",
        read_timeout_s: float = READ_TIMEOUT_S,
        log=logger.info,
    ):
        self.orch = orch
        self.tokens = tokens
        self.registry = registry
        self.root = root
        self.read_timeout_s = float(read_timeout_s)
        self.journal = AdmissionJournal(root)
        self.log = log
        self.net_dir = os.path.join(root, NET_DIR)
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        # The terminal marker: every job that finishes (search, store
        # hit, or quarantine) lands a durable "done" record so restart
        # replay skips it.  The orchestrator exception-guards the call.
        orch.on_terminal = self.journal.mark_done
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # StreamRequestHandler honors this as the per-connection
            # socket timeout: a half-open or slowloris client is cut
            # off here instead of wedging its handler thread forever.
            timeout = self.read_timeout_s

            def do_POST(self) -> None:  # noqa: N802 (stdlib API name)
                outer._dispatch(self, "POST")

            def do_GET(self) -> None:  # noqa: N802 (stdlib API name)
                outer._dispatch(self, "GET")

            def log_message(self, fmt, *args) -> None:
                # Request logging belongs to `logging`, never stderr
                # (the CLI's stdout/stderr are the search's).
                logger.debug("net: " + fmt, *args)

        class Server(ThreadingHTTPServer):
            # Handler threads must never outlive shutdown, and a
            # connection-level error (reset mid-response) is a debug
            # line, not a stderr traceback.
            daemon_threads = True

            def handle_error(self, request, client_address) -> None:
                logger.debug(
                    "net: connection error from %s",
                    client_address, exc_info=True,
                )

        self._server = Server((host, int(port)), Handler)

    # -- lifecycle ---------------------------------------------------------

    @property
    def port(self) -> int:
        """The bound port (``port=0`` binds ephemeral)."""
        return int(self._server.server_address[1])

    def replay(self) -> list:
        """Restart recovery: re-serves every admitted-but-unfinished
        job from the admission journal.  Call BEFORE :meth:`start` —
        recovered work is admitted ahead of new network traffic."""
        return self.journal.replay(self.orch, log=self.log)

    def start(self) -> "AdmissionServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._serve, name="sbg-admit", daemon=True
            )
            self._thread.start()
        return self

    def _serve(self) -> None:
        try:
            self._server.serve_forever(poll_interval=0.2)
        except Exception as e:
            logger.warning("admission server exited: %r", e)

    def close(self, timeout: float = 5.0) -> None:
        """Drain step one: stop accepting (listener closed, accept
        thread joined).  Already-admitted jobs keep running — the
        orchestrator drain that follows preempts and publishes them,
        and the admission journal re-serves them next boot.  Closes
        the listener of a server never started too.  Idempotent."""
        t, self._thread = self._thread, None
        if t is not None:
            # shutdown() waits for serve_forever, so only when it runs.
            self._server.shutdown()
            t.join(timeout)
        if not self._closed:
            self._closed = True
            self._server.server_close()

    # -- request plumbing --------------------------------------------------

    def _dispatch(self, h, method: str) -> None:
        """One request, every outcome a response: structured 4xx for
        client errors, 503 for injected faults (that request only —
        the serve loop survives every armed chaos site), 500 + flight
        dump for anything unexpected."""
        self.registry.inc("net_requests")
        try:
            faults.fault_point("net.accept")
            url = urlsplit(h.path)
            if method == "POST" and url.path == "/v1/jobs":
                self._post_job(h)
            elif method == "GET" and url.path.startswith("/v1/jobs/"):
                self._get_job(h, url)
            else:
                raise _HttpError(404, "not_found", "try /v1/jobs")
        except _HttpError as e:
            self._send_error(h, e.status, e.code, str(e))
        except faults.InjectedFault as e:
            self.registry.inc("net_errors")
            dump = self._flight("net_injected", h, e)
            self._send_error(
                h, 503, "unavailable",
                f"injected fault ({e}); safe to retry on the same "
                "Idempotency-Key", flight=dump,
            )
        except BrokenPipeError:
            pass  # client went away mid-response; nothing to send
        except Exception as e:
            logger.warning("net: request failed: %r", e)
            self.registry.inc("net_errors")
            dump = self._flight("net_error", h, e)
            self._send_error(
                h, 500, "internal", repr(e), flight=dump
            )

    def _flight(self, reason: str, h, exc) -> Optional[str]:
        try:
            return _tflight.flight_dump(
                reason, registry=self.registry, directory=self.net_dir,
                extra={"path": h.path, "error": repr(exc)},
            )
        except Exception as e:
            logger.warning("net: flight dump failed: %r", e)
            return None

    def _send_json(self, h, status: int, doc: dict) -> None:
        body = json.dumps(doc, sort_keys=True).encode("utf-8")
        try:
            h.send_response(status)
            h.send_header("Content-Type", "application/json")
            h.send_header("Content-Length", str(len(body)))
            h.end_headers()
            h.wfile.write(body)
        except OSError:
            pass  # client went away; the admission already happened

    def _send_error(
        self, h, status: int, code: str, message: str,
        flight: Optional[str] = None,
    ) -> None:
        err = {"status": status, "code": code, "message": message}
        if flight:
            err["flight"] = flight
        self._send_json(h, status, {"error": err})

    # -- admission steps ---------------------------------------------------

    def _auth(self, h) -> Tenant:
        """Steps 2-3: bearer-token authn + the per-tenant rate bucket.
        Both run before any body byte is read — an unauthenticated or
        rate-limited client costs one header parse, nothing more."""
        faults.fault_point("net.auth")
        try:
            tenant = self.tokens.authenticate(
                h.headers.get("Authorization")
            )
        except AuthError as e:
            self.registry.inc("net_rejected_auth")
            raise _HttpError(e.status, e.code, str(e))
        if not self.tokens.allow(tenant.name):
            self.registry.inc("net_rejected_rate")
            raise _HttpError(
                429, "rate_limited",
                f"tenant {tenant.name!r} over its request rate",
            )
        return tenant

    def _read_body(self, h) -> bytes:
        """Step 4: the bounded body read.  Oversize -> 413 before a
        byte is read; a stalled sender -> 408 at the socket timeout —
        either way one counter, one response, and the handler thread
        is released."""
        faults.fault_point("net.body")
        raw_len = h.headers.get("Content-Length")
        if raw_len is None:
            raise _HttpError(
                411, "length_required", "Content-Length required"
            )
        try:
            length = int(raw_len)
        except ValueError:
            raise _HttpError(400, "bad_request", "bad Content-Length")
        if length < 0:
            raise _HttpError(400, "bad_request", "bad Content-Length")
        if length > MAX_BODY_BYTES:
            self.registry.inc("net_oversize")
            raise _HttpError(
                413, "payload_too_large",
                f"body of {length} bytes exceeds the "
                f"{MAX_BODY_BYTES}-byte bound",
            )
        try:
            data = h.rfile.read(length)
        except socket.timeout:
            self.registry.inc("net_timeouts")
            raise _HttpError(
                408, "request_timeout",
                f"body not received within {self.read_timeout_s:g}s",
            )
        except OSError:
            raise _HttpError(400, "bad_request", "body read failed")
        if len(data) < length:
            raise _HttpError(
                400, "bad_request", "body shorter than Content-Length"
            )
        return data

    def _parse_job(self, body: bytes) -> dict:
        """Validates the POST document down to a typed option set (the
        options subset a network tenant may steer)."""
        try:
            doc = json.loads(body.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise _HttpError(400, "bad_request", f"invalid JSON ({e})")
        if not isinstance(doc, dict):
            raise _HttpError(400, "bad_request", "expected a JSON object")
        text = doc.get("sbox")
        if not isinstance(text, str):
            raise _HttpError(
                400, "bad_request", "missing 'sbox' (hex table text)"
            )
        try:
            sbox, n_in = parse_sbox(text)
        except SboxError as e:
            raise _HttpError(400, "bad_sbox", str(e))
        try:
            output = int(doc.get("output", -1))
            priority = int(doc.get("priority", 0))
            permute = int(doc.get("permute", 0))
        except (TypeError, ValueError):
            raise _HttpError(
                400, "bad_request",
                "output/priority/permute must be integers",
            )
        if not -1 <= output <= 7:
            raise _HttpError(
                400, "bad_request", "output must be -1 (all) or 0..7"
            )
        if not 0 <= permute < (1 << n_in):
            raise _HttpError(
                400, "bad_request",
                f"permute must be in [0, {1 << n_in})",
            )
        metric = int(self.orch.ctx.opt.metric)
        if "metric" in doc and int(doc["metric"]) != metric:
            raise _HttpError(
                400, "bad_request",
                f"this pool serves metric {metric} only",
            )
        return {
            "sbox": sbox, "n_in": n_in, "output": output,
            "priority": priority, "permute": permute, "metric": metric,
        }

    def _store_sbox(self, opts: dict) -> str:
        """Step 5a: lands the posted table content-addressed under
        ``root/_net/`` (durable write, skipped when present) — the
        replayable ``sbox_path`` the admission journal records."""
        values = opts["sbox"][: 1 << opts["n_in"]]
        text = canonical_sbox_text(values)
        digest = hashlib.blake2b(
            text.encode("utf-8"), digest_size=8
        ).hexdigest()
        path = os.path.join(self.net_dir, f"sbox-{digest}.txt")
        if not os.path.exists(path):
            os.makedirs(self.net_dir, exist_ok=True)
            durable_write_text(path, text)
        return path

    def _job_key(self, opts: dict) -> str:
        """Step 5b: the canonical query key — the same key the
        result store files circuits under, so two tenants posting the
        same query (under any formatting) collide here and share one
        search."""
        sbox, n_in = opts["sbox"], opts["n_in"]
        if opts["permute"]:
            sbox = permuted_box(sbox, n_in, opts["permute"])
        mask = tt.mask_table(n_in)
        if opts["output"] >= 0:
            target = tt.target_table(sbox, opts["output"])
            key, _ = _canon.canonicalize(target, mask, opts["metric"])
            return key
        try:
            n_out = num_outputs(sbox, n_in)
        except SboxError as e:
            raise _HttpError(400, "bad_sbox", str(e))
        targets = make_targets(sbox)[:n_out]
        return _canon.exact_multi_key(targets, mask, opts["metric"])

    # -- POST /v1/jobs -----------------------------------------------------

    def _post_job(self, h) -> None:
        t0 = time.perf_counter()
        tenant = self._auth(h)
        body = self._read_body(h)
        opts = self._parse_job(body)
        # torchlint: ignore[R13] the idempotency key is journaled verbatim by design (replay dedup needs the exact client token); bounded by the HTTP header-line cap and never used in a path or command
        idem = h.headers.get("Idempotency-Key", "")
        key = self._job_key(opts)
        job_id = "net-" + hashlib.blake2b(
            f"{key}\x00{idem}".encode("utf-8"), digest_size=8
        ).hexdigest()

        existing = self.orch.job(job_id)
        if existing is not None:
            self._answer_existing(h, existing, t0)
            return
        # Fresh admission: quota, then the durable admit record, then
        # the orchestrator — strictly in that order, so an over-quota
        # tenant never touches the journal and a journaled job is
        # never lost to a crash before enqueue.
        active = self.orch.active_jobs(tenant.name)
        if active >= tenant.max_jobs:
            self.registry.inc("net_rejected_quota")
            raise _HttpError(
                429, "over_quota",
                f"tenant {tenant.name!r} has {active} active jobs "
                f"(quota {tenant.max_jobs})",
            )
        job = ServeJob(
            job_id=job_id,
            sbox_path=self._store_sbox(opts),
            output=opts["output"],
            tenant=tenant.name,
            priority=opts["priority"],
            permute=opts["permute"],
        )
        self.journal.admit(job, key=key, idem=idem)
        try:
            self.orch.submit(job)
        except ServeClosed as e:
            raise _HttpError(503, "draining", str(e))
        except ValueError:
            # Lost the race against a concurrent identical POST: the
            # winner's job is in — join it (one search, N clients).
            joined = self.orch.join(job_id)
            if joined is not None:
                self._answer_existing(h, joined, t0, pre_joined=True)
                return
            raise
        self.registry.inc("net_jobs_admitted")
        self.registry.observe("net_admit_s", time.perf_counter() - t0)
        if job.state == DONE:
            # Store hit at admission: circuit now, zero dispatches.
            self.registry.inc("net_repeat_hits")
            self._send_json(h, 200, self._job_doc(job, circuits=True))
            return
        self._send_json(h, 202, self._job_doc(job))

    def _answer_existing(
        self, h, job: ServeJob, t0: float, pre_joined: bool = False
    ) -> None:
        """The idempotent-repeat surface: a COMPLETED job answers 200
        with its circuit (zero device dispatches — the artifacts are
        already on disk); an in-flight job is joined (202) — never a
        duplicate search."""
        if job.state == DONE:
            self.registry.inc("net_repeat_hits")
            self.registry.observe(
                "net_admit_s", time.perf_counter() - t0
            )
            self._send_json(h, 200, self._job_doc(job, circuits=True))
            return
        if job.state == QUARANTINED:
            # Terminal without a circuit: report it, don't re-search —
            # the operator quarantined this query for a reason.
            self._send_json(h, 200, self._job_doc(job))
            return
        if not pre_joined:
            # torchlint: ignore[R14] join of an already-admitted job re-serves existing work; quota guards fresh admissions only (auth ran in _dispatch before this handler)
            self.orch.join(job_id=job.job_id)
        self.registry.inc("net_joined")
        self.registry.observe("net_admit_s", time.perf_counter() - t0)
        # torchlint: ignore[R14] this 202 re-acknowledges a job whose admit record was fsync'd by the original admission; no new durable state to lose
        self._send_json(h, 202, self._job_doc(job))

    # -- GET /v1/jobs/<id> -------------------------------------------------

    def _get_job(self, h, url) -> None:
        self._auth(h)
        job_id = url.path[len("/v1/jobs/"):]
        if not job_id or "/" in job_id:
            raise _HttpError(404, "not_found", "bad job id")
        wait = 0.0
        q = parse_qs(url.query)
        if "wait" in q:
            try:
                wait = min(max(float(q["wait"][0]), 0.0), MAX_WAIT_S)
            except ValueError:
                raise _HttpError(400, "bad_request", "bad wait value")
        job = self.orch.job(job_id)
        if job is None:
            raise _HttpError(404, "not_found", f"no job {job_id!r}")
        if wait > 0 and job.state not in TERMINAL:
            # The long-poll primitive: a pure condition-variable wait
            # inside the orchestrator (zero device syncs, zero
            # polling); bounded, so a drain never waits on a reader.
            job = self.orch.wait_terminal(job_id, wait) or job
        self._send_json(
            h, 200, self._job_doc(job, circuits=job.state == DONE)
        )

    # -- response documents ------------------------------------------------

    def _job_doc(self, job: ServeJob, circuits: bool = False) -> dict:
        doc = {
            "schema": NET_SCHEMA,
            "job_id": job.job_id,
            "state": job.state,
            "tenant": job.tenant,
            "priority": job.priority,
        }
        if job.joined:
            doc["joined"] = job.joined
        if job.store is not None:
            doc["store"] = job.store
        if job.result_count is not None:
            doc["results"] = job.result_count
        if job.error is not None:
            doc["error"] = job.error
        reg = job.registry
        if reg is not None and job.state == RUNNING:
            # Progress reads the per-job registry FORK — host-side
            # counters only, zero device syncs (the /status contract).
            doc["dispatches"] = int(reg.get("device_dispatches", 0))
        if circuits and job.state == DONE:
            out = []
            for path in self.orch.result_files(job.job_id):
                try:
                    with open(path, "r", encoding="utf-8") as f:
                        out.append({
                            "file": os.path.basename(path),
                            "xml": f.read(),
                        })
                except OSError as e:
                    logger.warning(
                        "net: cannot read result %s (%r)", path, e
                    )
            doc["circuits"] = out
        return doc
