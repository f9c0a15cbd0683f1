"""``sbg top``: a read-only terminal watcher over a run's heartbeat JSONL
(``python -m sboxgates_tpu_torch.telemetry.watch DIR``).

The watcher tails ``telemetry.jsonl``, the file every run with an explicit
``--output-dir`` writes, so it attaches to runs it did not start and to dead
runs (a killed run's last line bounds when it died and what it had done).
The port and the JAX package write the same line schema, so it follows a
run of either.  It opens nothing else and writes nothing.

``--once`` renders the latest record and exits; the default follows the
file like ``tail -f``, re-rendering a compact summary (uptime, dispatch and
candidate counters with their rates since the previous line, histogram
quantiles) each time a line lands, until the run's final line.

A daemon reader thread (:meth:`Tail._work`) polls the file and queues
parsed records; the main thread renders, so Ctrl-C lands in the render
loop, never inside a read.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import sys
import threading
from typing import List, Optional

from .heartbeat import JSONL_NAME

#: Counters the summary leads with, where a record has them.
TOP_COUNTERS = (
    "device_dispatches",
    "pair_candidates",
    "lut3_candidates",
    "lut5_candidates",
    "lut7_candidates",
    "warm_hits",
    "warm_misses",
    "kernel_compiles",
    "deadline_breaches",
    "circuit_breaker_trips",
)

#: Histograms whose quantiles the summary shows when present.
TOP_HISTOGRAMS = (
    "dispatch_latency_s",
    "device_wait_s",
    "job_seconds",
    "job_time_to_first_hit_s",
)


def read_records(path: str) -> List[dict]:
    """Every parseable heartbeat record in the file (a torn last line from
    a crash is skipped, not fatal)."""
    out: List[dict] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
    return out


class Tail:
    """Background reader: follows the JSONL file and queues each parsed
    record (the records present at attach time included)."""

    def __init__(self, path: str, poll_s: float = 1.0):
        self.path = path
        self.poll_s = poll_s
        self.records: "queue.Queue[dict]" = queue.Queue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Tail":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._work, name="sbg-watch-tail", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(self.poll_s + 2.0)

    def _work(self) -> None:
        pos = 0
        buf = ""
        while not self._stop.is_set():
            try:
                with open(self.path, "r", encoding="utf-8") as f:
                    f.seek(pos)
                    chunk = f.read()
                    pos = f.tell()
            except OSError:
                chunk = ""
            buf += chunk
            while "\n" in buf:
                line, buf = buf.split("\n", 1)
                line = line.strip()
                if not line:
                    continue
                try:
                    self.records.put(json.loads(line))
                except ValueError:
                    continue
            if self._stop.wait(self.poll_s):
                return


def _fmt_rate(v: float) -> str:
    for unit, div in (("G", 1e9), ("M", 1e6), ("k", 1e3)):
        if abs(v) >= div:
            return f"{v / div:.2f}{unit}"
    return f"{v:.1f}"


def render(rec: dict, prev: Optional[dict] = None) -> str:
    """One summary block for a heartbeat record; ``prev`` (the preceding
    record) turns counter deltas into rates."""
    lines = []
    kind = str(rec.get("kind", "?"))
    head = (
        f"run rank={rec.get('rank', '?')} pid={rec.get('pid', '?')} "
        f"uptime={rec.get('uptime_s', 0):.0f}s seq={rec.get('seq', '?')} "
        f"kind={kind}"
    )
    # Only a final line is terminal: incident lines are also written by
    # dumps the run survives (a breaker trip).
    if kind == "final":
        head += "  [terminal record — run is over]"
    elif kind.startswith("incident:"):
        head += "  [incident dump fired — run may still be live]"
    lines.append(head)
    counters = rec.get("counters", {})
    dt = None
    if prev is not None:
        dt = rec.get("uptime_s", 0) - prev.get("uptime_s", 0)
    for name in TOP_COUNTERS:
        if name not in counters:
            continue
        v = counters[name]
        row = f"  {name:<24} {v:>14,.0f}"
        if dt and dt > 0 and prev is not None:
            dv = v - prev.get("counters", {}).get(name, 0)
            row += f"  ({_fmt_rate(dv / dt)}/s)"
        lines.append(row)
    for name, q in sorted(rec.get("quantiles", {}).items()):
        if name.split("[", 1)[0] not in TOP_HISTOGRAMS:
            continue
        lines.append(
            f"  {name:<32} n={q.get('count', 0):<8,.0f}"
            f" p50={q.get('p50', float('nan')):.4g}s"
            f" p90={q.get('p90', float('nan')):.4g}s"
            f" p99={q.get('p99', float('nan')):.4g}s"
        )
    serve = rec.get("serve")
    if isinstance(serve, dict) and "counts" in serve:
        lines.extend(render_serve(serve))
    return "\n".join(lines)


#: Serve queue-view rows shown per refresh; the rest is summarized (a
#: thousand-tenant queue must not scroll the terminal away).
SERVE_MAX_ROWS = 16

#: Display order: live states first, terminal states last.
_SERVE_STATE_ORDER = {
    "running": 0, "preempted": 1, "queued": 2,
    "quarantined": 3, "done": 4,
}


def render_serve(serve: dict) -> List[str]:
    """The serve-mode per-job queue section of one heartbeat record
    (written by the orchestrator's status provider): aggregate counts,
    then up to :data:`SERVE_MAX_ROWS` per-job rows — state, tenant,
    priority, bucket, retries/preemptions, and the job's ttfh so far."""
    counts = serve.get("counts", {})
    store = serve.get("store")
    head = (
        f"  serve lanes={serve.get('lanes', '?')}"
        f" bucket={serve.get('lane_bucket', '?')}"
        + (
            f" waves={serve['waves']}"
            if serve.get("merge") and serve.get("waves") else ""
        )
        + (
            f" store hit={store.get('hits', 0)}"
            f"/part={store.get('partial_hits', 0)}"
            f"/miss={store.get('misses', 0)}"
            + ("(ro)" if store.get("readonly") else "")
            if isinstance(store, dict) else ""
        )
        + (" DRAINING" if serve.get("draining") else "")
    )
    lines = [head, "    " + "  ".join(
        f"{k}={counts.get(k, 0)}"
        for k in ("queued", "running", "preempted", "quarantined", "done")
    )]
    jobs = serve.get("jobs", {})
    rows = sorted(
        jobs.items(),
        key=lambda kv: (
            _SERVE_STATE_ORDER.get(kv[1].get("state", ""), 9), kv[0]
        ),
    )
    for job_id, row in rows[:SERVE_MAX_ROWS]:
        bits = [
            f"    {job_id:<16} {row.get('state', '?'):<11}",
            f"tenant={row.get('tenant', '?')}",
            f"prio={row.get('priority', 0)}",
            f"bucket={row.get('bucket', '?')}",
        ]
        if "wave" in row:
            bits.append(f"wave={row['wave']}")
        if "store" in row:
            bits.append(f"store={row['store']}")
        if row.get("failures"):
            bits.append(f"fail={row['failures']}")
        if row.get("preemptions"):
            bits.append(f"preempt={row['preemptions']}")
        if "ttfh_s" in row:
            bits.append(f"ttfh={row['ttfh_s']:.3g}s")
        if "queue_wait_s" in row:
            bits.append(f"wait={row['queue_wait_s']:.3g}s")
        if "running_s" in row:
            bits.append(f"run={row['running_s']:.3g}s")
        lines.append(" ".join(bits))
    if len(rows) > SERVE_MAX_ROWS:
        lines.append(f"    ... {len(rows) - SERVE_MAX_ROWS} more jobs")
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m sboxgates_tpu_torch.telemetry.watch",
        description="read-only top-style watcher over a run's "
        "telemetry.jsonl heartbeat (live or dead runs alike)",
    )
    p.add_argument("dir", help="run --output-dir (holds telemetry.jsonl)")
    p.add_argument(
        "--once", action="store_true",
        help="render the latest record and exit (default: follow)",
    )
    p.add_argument(
        "--interval", type=float, default=1.0, metavar="S",
        help="poll period while following (default 1s)",
    )
    args = p.parse_args(argv)
    path = os.path.join(args.dir, JSONL_NAME)
    if not os.path.exists(path):
        print(f"no {JSONL_NAME} in {args.dir}", file=sys.stderr)
        return 1
    if args.once:
        recs = read_records(path)
        if not recs:
            print("no heartbeat records yet", file=sys.stderr)
            return 1
        print(render(recs[-1], recs[-2] if len(recs) > 1 else None))
        return 0
    tail = Tail(path, poll_s=args.interval).start()
    prev = None
    try:
        while True:
            try:
                rec = tail.records.get(timeout=0.5)
            except queue.Empty:
                continue
            # Drain to the newest queued record; render once per batch.
            while True:
                try:
                    nxt = tail.records.get_nowait()
                except queue.Empty:
                    break
                prev, rec = rec, nxt
            print(render(rec, prev), flush=True)
            print("", flush=True)
            prev = rec
            if rec.get("kind") == "final":
                return 0
    except KeyboardInterrupt:
        return 0
    finally:
        tail.stop()


if __name__ == "__main__":
    sys.exit(main())
