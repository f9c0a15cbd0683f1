"""The port's live introspection: the ``/status`` endpoint and the
heartbeat watcher, on the CPU.

Port counterparts of the JAX package's tests/test_status.py: the
endpoint's schema, coverage and ETA, request counting and clean shutdown;
a provider failure degrading to an error note; a CLI run with
``--status-port 0`` whose bound port rides the heartbeat's start line and
whose /status counters the final ``metrics.json`` reaches; the watcher on a
dead run, following appends, and on a missing directory.  The watcher on a
run of the JAX CLI is in tests/test_torch_search.py, beside that CLI's runs.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from sboxgates_tpu_torch.telemetry import metrics as tmetrics
from sboxgates_tpu_torch.telemetry import status as tstatus
from sboxgates_tpu_torch.telemetry import watch as twatch
from sboxgates_tpu_torch.telemetry.heartbeat import Heartbeat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DES = os.path.join(ROOT, "tests", "data", "des_s1.txt")

#: Top-level /status keys (the JAX package's schema).
STATUS_KEYS = {
    "schema", "time_unix", "uptime_s", "counters", "histograms",
    "coverage", "attribution",
}


def _get_status(port, timeout=10):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}/status", timeout=timeout
    ) as resp:
        return json.load(resp)


def test_status_server_snapshot_schema_and_shutdown():
    reg = tmetrics.context_registry()
    reg.inc("device_dispatches", 3)
    reg.inc("lut5_candidates", 1000)
    reg.observe("dispatch_latency_s[lut5_filter/1024x64]", 0.01)
    srv = tstatus.StatusServer(
        reg, port=0, extra={"engine": lambda: {"native": False}},
        gates_fn=lambda: 24,
    ).start()
    try:
        doc = _get_status(srv.port)
        assert set(doc) == STATUS_KEYS | {"engine"}
        assert doc["schema"] == tstatus.STATUS_SCHEMA
        assert doc["counters"]["device_dispatches"] == 3
        h = doc["histograms"]["dispatch_latency_s[lut5_filter/1024x64]"]
        assert {"p50", "p90", "p99"} <= set(h)
        cov = doc["coverage"]["lut5_candidates"]
        assert cov["examined"] == 1000
        assert cov["current_space"] == 42504  # C(24, 5)
        assert cov["eta_current_space_s"] > 0
        assert doc["engine"] == {"native": False}
        assert set(doc["attribution"]) >= {"backend", "peaks", "rows"}
        assert reg["status_requests"] == 1
        assert reg.undeclared() == set()
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/nope", timeout=5)
    finally:
        srv.shutdown()
    assert not any(t.name == "sbg-status" for t in threading.enumerate())
    srv.shutdown()  # idempotent


def test_status_provider_failure_degrades_to_error_note():
    reg = tmetrics.MetricsRegistry(declared=None)

    def boom():
        raise RuntimeError("provider died")

    srv = tstatus.StatusServer(reg, port=0, extra={"bad": boom}).start()
    try:
        doc = _get_status(srv.port)
        assert "error" in doc["bad"] and "counters" in doc
    finally:
        srv.shutdown()


def test_coverage_derivation_edge_cases():
    cov = tstatus.coverage({"lut5_candidates": 10}, uptime_s=2.0)
    assert cov["lut5_candidates"]["examined"] == 10
    assert cov["lut5_candidates"]["rate_per_s"] == 5.0
    assert "current_space" not in cov["lut5_candidates"]
    cov = tstatus.coverage({"lut7_candidates": 5}, uptime_s=1.0, g=4)
    assert "current_space" not in cov["lut7_candidates"]  # g < k
    assert tstatus.coverage({}, uptime_s=1.0) == {}


def test_status_endpoint_of_a_cli_run(tmp_path):
    """A device-route run with ``--status-port 0``: the bound port is in
    the heartbeat's start line, /status serves the run's counters and
    engine state mid-search, and the final metrics.json (written at the
    SIGTERM's teardown) holds at least what /status showed."""
    out = tmp_path / "run"
    env = dict(os.environ, PYTHONPATH=ROOT, SBG_DISABLE_NATIVE="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "sboxgates_tpu_torch", DES, "-o", "0", "--seed",
         "1", "--device", "cpu", "--output-dir", str(out), "--status-port", "0",
         "--metrics-interval", "0.05"],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
    )
    try:
        hb = out / "telemetry.jsonl"
        deadline = time.monotonic() + 120
        doc = None
        while time.monotonic() < deadline and proc.poll() is None:
            if hb.exists() and len(hb.read_text().splitlines()) >= 2:
                start = json.loads(hb.read_text().splitlines()[0])
                doc = _get_status(start["config"]["status_port"])
                if doc["counters"].get("device_dispatches", 0) > 0:
                    break
            time.sleep(0.05)
        assert proc.poll() is None, proc.stderr.read()
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert set(doc) == STATUS_KEYS | {"engine"}
    assert doc["engine"]["native"] is False and doc["engine"]["device"] == "cpu"
    assert doc["engine"]["last_dispatch_gates"] >= 6
    final = json.load(open(out / "metrics.json"))["counters"]
    for k, v in doc["counters"].items():
        if k != "status_requests":
            assert final[k] >= v, k
    assert final["status_requests"] >= 1


def test_watch_renders_dead_run(tmp_path):
    """The watcher reads only the heartbeat JSONL: it renders a run it did
    not start, after the run has ended."""
    reg = tmetrics.context_registry()
    reg.inc("device_dispatches", 42)
    reg.observe("dispatch_latency_s[pivot_window/64x256x512]", 0.02)
    Heartbeat(reg, str(tmp_path), interval_s=0).start().stop(snapshot=False)
    proc = subprocess.run(
        [sys.executable, "-m", "sboxgates_tpu_torch.telemetry.watch",
         str(tmp_path), "--once"],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=ROOT),
    )
    assert proc.returncode == 0, proc.stderr
    assert "terminal record" in proc.stdout
    assert "device_dispatches" in proc.stdout and "42" in proc.stdout
    assert "dispatch_latency_s[pivot_window/64x256x512]" in proc.stdout


def test_watch_tail_follows_appends(tmp_path):
    path = tmp_path / "telemetry.jsonl"
    path.write_text(json.dumps({"kind": "start", "seq": 0}) + "\n")
    tail = twatch.Tail(str(path), poll_s=0.05).start()
    try:
        assert tail.records.get(timeout=5)["kind"] == "start"
        with open(path, "a") as f:
            f.write(json.dumps({"kind": "beat", "seq": 1}) + "\n")
        assert tail.records.get(timeout=5)["seq"] == 1
    finally:
        tail.stop()
    assert not any(t.name == "sbg-watch-tail" for t in threading.enumerate())


def test_watch_missing_dir_fails_cleanly(tmp_path):
    assert twatch.main([str(tmp_path / "nope"), "--once"]) == 1
