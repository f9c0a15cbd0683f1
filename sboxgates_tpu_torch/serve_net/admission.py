"""The durable admission journal: every job the network front door
accepts is fsync'd to an append-only JSONL BEFORE the client sees its
202 — a crash between accept and orchestrator enqueue loses nothing,
because the next boot replays the journal into the orchestrator.

Same discipline as the search journal (``resilience.journal``): one
JSON object per line, ``flush`` + ``fsync`` per record, torn final
lines tolerated on load (a kill mid-append costs that record's client
its 202 retry, never the file).  Records carry NO wall-clock values —
replay must be deterministic, and the per-job seed is already derived
from the job id (``serve.job_seed``).

Record shapes::

    {"seq": 0, "type": "admit", "job_id": "net-...", "tenant": "alice",
     "key": "<canonical query key>", "idem": "<Idempotency-Key>",
     "sbox_file": "...", "output": -1, "permute": 0, "priority": 0}
    {"seq": 1, "type": "done", "job_id": "net-...", "state": "done"}

``done`` markers ride the orchestrator's ``on_terminal`` observer, so
replay skips completed jobs (the observer returns before the serve can
report idle or a long-poll can see the job terminal, so a process that
exits after ``run_until_idle``/``run_until_drained`` leaves nothing
pending); a job admitted twice (a 503-then-retry on
the same idempotency key) dedups here — first record wins.

Chaos: the ``net.admit_journal`` site fires AFTER the record is
durable.  An armed ``raise`` is the accepted-but-not-enqueued window
surfaced as a 503 the client can retry on its idempotency key (the
retry joins or dedups — never a duplicate search); an armed ``crash``
is the kill the replay test exercises end-to-end.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Dict, List, Optional

from ..resilience import faults
from ..search.serve import TERMINAL, ServeClosed, ServeJob

logger = logging.getLogger(__name__)

ADMIT_JOURNAL_NAME = "admission.journal.jsonl"
#: admission journal schema version (recorded on every admit row).
ADMIT_VERSION = 1


class AdmissionJournal:
    """Append-only fsync'd admission record; see the module docstring."""

    def __init__(self, root: str):
        self.root = root
        self.path = os.path.join(root, ADMIT_JOURNAL_NAME)
        self._lock = threading.Lock()
        self._seq = len(self.load(root))

    # -- writing -----------------------------------------------------------

    def append(self, rtype: str, **payload) -> dict:
        """Appends one record and returns it once DURABLE (flush +
        fsync).  The ``net.admit_journal`` chaos site fires after the
        fsync, outside the lock: an injected crash there is precisely
        the accepted-but-not-enqueued window the replay contract
        covers."""
        os.makedirs(self.root, exist_ok=True)
        with self._lock:
            rec = {"seq": self._seq, "type": rtype, **payload}
            with open(self.path, "a", encoding="utf-8") as f:
                f.write(json.dumps(rec, sort_keys=True) + "\n")
                f.flush()
                os.fsync(f.fileno())
            self._seq += 1
        faults.fault_point("net.admit_journal")
        return rec

    def admit(self, job: ServeJob, key: str, idem: str) -> dict:
        """The admit record for one accepted job (sbox paths are stored
        relative to the journal root when possible, so a relocated run
        directory replays)."""
        sbox_file = job.sbox_path
        try:
            rel = os.path.relpath(sbox_file, self.root)
            if not rel.startswith(".."):
                sbox_file = rel
        except ValueError:
            pass
        return self.append(
            "admit", version=ADMIT_VERSION, job_id=job.job_id,
            tenant=job.tenant, key=key, idem=idem, sbox_file=sbox_file,
            output=job.output, permute=job.permute,
            priority=job.priority,
        )

    def mark_done(self, job: ServeJob) -> None:
        """The terminal marker (wired to ``ServeOrchestrator.
        on_terminal``): replay skips jobs recorded here.  Exception-
        guarded by the orchestrator's observer contract."""
        self.append("done", job_id=job.job_id, state=job.state)

    # -- reading / replay --------------------------------------------------

    @staticmethod
    def load(root: str) -> List[dict]:
        """All records, tolerating a torn final line (the mid-append
        kill) — mirrors ``SearchJournal.load_records``."""
        path = os.path.join(root, ADMIT_JOURNAL_NAME)
        records: List[dict] = []
        try:
            with open(path, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        records.append(json.loads(line))
                    except json.JSONDecodeError:
                        break  # torn tail: earlier records rule
        except OSError:
            return []
        return records

    def replay(self, orch, log=logger.info) -> List[str]:
        """Re-submits every admitted-but-unfinished job into ``orch``
        (restart recovery, called before the listener opens).  Dedup:
        the FIRST admit record per job id wins; jobs with a ``done``
        marker, or already known to the orchestrator, are skipped.
        Returns the re-submitted job ids in admission order."""
        admits: Dict[str, dict] = {}
        done = set()
        for rec in self.load(self.root):
            rtype = rec.get("type")
            job_id = rec.get("job_id")
            if not job_id:
                continue
            if rtype == "admit" and job_id not in admits:
                admits[job_id] = rec
            elif rtype == "done":
                done.add(job_id)
        resubmitted: List[str] = []
        for job_id, rec in admits.items():
            if job_id in done:
                continue
            existing = orch.job(job_id)
            if existing is not None:
                if existing.state in TERMINAL:
                    # Terminal in the orchestrator but unmarked here (a
                    # crash between the transition and our marker):
                    # repair the journal so the NEXT boot skips it too.
                    self.mark_done(existing)
                continue
            sbox_path = rec.get("sbox_file", "")
            if not os.path.isabs(sbox_path):
                sbox_path = os.path.join(self.root, sbox_path)
            job = ServeJob(
                job_id=job_id,
                sbox_path=sbox_path,
                output=int(rec.get("output", -1)),
                tenant=str(rec.get("tenant", "default")),
                priority=int(rec.get("priority", 0)),
                permute=int(rec.get("permute", 0)),
            )
            try:
                # torchlint: ignore[R14] boot replay re-serves jobs that passed auth+quota at their original accept; the admission checks do not re-run on recovery by design
                orch.submit(job)
            except ServeClosed:
                log(
                    f"admit replay: orchestrator draining; job "
                    f"{job_id} left for the next boot"
                )
                break
            except (OSError, ValueError) as e:
                logger.warning(
                    "admit replay: cannot re-submit job %s (%r)",
                    job_id, e,
                )
                continue
            resubmitted.append(job_id)
            log(f"admit replay: re-serving job {job_id} "
                f"(tenant {job.tenant})")
        return resubmitted


def pending_jobs(root: str) -> List[str]:
    """Admitted-but-unfinished job ids in ``root``'s admission journal
    (first-admit order) — the cheap restart probe the CLI logs before
    replaying."""
    admits: List[str] = []
    done = set()
    for rec in AdmissionJournal.load(root):
        job_id = rec.get("job_id")
        if not job_id:
            continue
        if rec.get("type") == "admit" and job_id not in admits:
            admits.append(job_id)
        elif rec.get("type") == "done":
            done.add(job_id)
    return [j for j in admits if j not in done]
