"""The search journal: exact resume for interrupted searches.

A :class:`SearchJournal` is an append-only JSONL file in the run's output
directory, fsync'd per record, plus an atomically replaced JSON snapshot
(so even a torn JSONL tail — the worst a crash can do to an append — loses
at most the record being written, and the reader tolerates that).

Records carry what the drivers need to continue a killed search so that the
final circuits are bit-identical to an uninterrupted run with the same seed:

- ``run_start`` — the search configuration (inputs, flags, the
  materialized seed), so ``--resume-run DIR`` rebuilds the run without its
  command line;
- ``iter_done`` / ``round_done`` — completed progress units: the result
  checkpoints by file name (the states live in the durable XML files),
  budget ratchets, and the host PRNG position (bit-generator state plus
  the unconsumed tail of the context's kernel-seed buffer);
- ``run_done`` — the finished run's final states, so resuming a finished
  run does nothing.

The files, their names and their bytes are the JAX package's
(``sboxgates_tpu/resilience/journal.py``, version 2): records serialise
with ``json.dumps(..., sort_keys=True)``, so a journal one package wrote
is resumed by the other, the per-job journals of the several-box and
fleet runs and the per-shard journals of a ``--shard-sweep`` run
(:func:`shard_dir`) included.  One writer per journal: rank 0 for the run
journal of several processes, whose other ranks restore from a
``readonly`` handle; each rank for its own shard journal.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, List, Optional

from ..telemetry import metrics as _tmetrics
from ..telemetry import trace as _ttrace
from .checkpoint import clean_stale_tmp, durable_write_text
from .faults import fault_point

#: The JAX package's journal version 2 (its per-job layout's version); a
#: single-process run's records are the same in both packages.
JOURNAL_VERSION = 2
JOURNAL_NAME = "search.journal.jsonl"
SNAPSHOT_NAME = "search.journal.json"
#: Snapshot refresh cadence (appends).  The JSONL is the source of truth;
#: a snapshot that lags by a few records only makes a resume redo those
#: units, deterministically.
SNAPSHOT_EVERY = 8


class JournalError(Exception):
    """The journal is missing, unreadable, or inconsistent."""


def shard_dir(root: str, rank: int) -> str:
    """The journal directory of rank ``rank``'s slice of a job-sharded
    sweep: ``root/shard-NN/``."""
    return os.path.join(root, f"shard-{rank:02d}")


class SearchJournal:
    """Append-only run journal; see the module docstring.

    :meth:`start` begins a fresh run (truncating any previous journal in
    the directory and writing ``run_start``); :meth:`resume` continues
    one (cleans stale checkpoint temp files, replays the records).  One
    writer per journal; a ``readonly`` handle restores but never writes.
    """

    def __init__(self, directory: str, records: List[dict],
                 readonly: bool = False, ckpt_root: Optional[str] = None):
        self.directory = directory
        self.records = records
        self.readonly = readonly
        # Where recorded checkpoint names resolve (default: the journal's
        # own directory; a shard journal's are the run's --output-dir).
        self.ckpt_root = ckpt_root
        # True when this handle continued an existing journal: per-job
        # journals take their fresh-or-resume choice from the run's.
        self.resumed = False
        self._unsnapshotted = 0

    # -- construction ------------------------------------------------------

    @classmethod
    def start(cls, directory: str, config: Dict[str, Any],
              ckpt_root: Optional[str] = None) -> "SearchJournal":
        os.makedirs(directory, exist_ok=True)
        j = cls(directory, [], ckpt_root=ckpt_root)
        # Drop the previous run's snapshot first: a crash between the
        # truncate and the run_start append must not leave an empty JSONL
        # beside a stale snapshot that a later resume would resurrect.
        try:
            os.unlink(os.path.join(directory, SNAPSHOT_NAME))
        except FileNotFoundError:
            pass
        durable_write_text(j._path, "")
        j.append("run_start", version=JOURNAL_VERSION, config=config)
        return j

    @classmethod
    def resume(cls, directory: str, readonly: bool = False,
               ckpt_root: Optional[str] = None) -> "SearchJournal":
        records = cls.load_records(directory)
        if not records or records[0].get("type") != "run_start":
            raise JournalError(
                f"no resumable journal in {directory!r} "
                f"(missing run_start record)"
            )
        j = cls(directory, records, readonly=readonly, ckpt_root=ckpt_root)
        j.resumed = True
        if not readonly:
            # Rewrite the JSONL as exactly the parsed records: appending
            # onto a torn, newline-less tail would weld the next record to
            # the fragment.
            try:
                clean_stale_tmp(directory)
                durable_write_text(
                    j._path,
                    "".join(json.dumps(r, sort_keys=True) + "\n" for r in records),
                )
            except OSError as e:
                logging.getLogger(__name__).warning(
                    "journal tail cleanup in %s failed (%s); continuing "
                    "with the parsed records", directory, e,
                )
        return j

    @classmethod
    def for_job(cls, root: str, job_id: str, config: Dict[str, Any], *,
                resume: bool, readonly: bool = False) -> "SearchJournal":
        """One job's journal under ``root/job_id/`` (the multi-box
        one-output driver's per-box journals).  ``resume=False`` starts it
        fresh; ``resume=True`` continues it, or starts it fresh when the job
        never journaled before the kill.  A ``readonly`` view replays and
        never writes (an empty handle when there is nothing to replay)."""
        d = os.path.join(root, job_id)
        if readonly:
            if resume:
                try:
                    return cls.resume(d, readonly=True)
                except JournalError:
                    pass
            return cls(d, [], readonly=True)
        if resume:
            try:
                return cls.resume(d)
            except JournalError:
                pass
        return cls.start(d, config)

    @property
    def writable(self) -> bool:
        return not self.readonly

    @staticmethod
    def load_records(directory: str) -> List[dict]:
        """Journal records, tolerating a torn final JSONL line; falls back
        to the snapshot when the JSONL holds no record."""
        path = os.path.join(directory, JOURNAL_NAME)
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
                        break  # torn tail
        except OSError:
            records = []
        if records:
            return records
        try:
            with open(os.path.join(directory, SNAPSHOT_NAME), "r",
                      encoding="utf-8") as f:
                data = json.load(f)
            return list(data.get("records", []))
        except (OSError, json.JSONDecodeError):
            return []

    # -- writing -----------------------------------------------------------

    @property
    def _path(self) -> str:
        return os.path.join(self.directory, JOURNAL_NAME)

    @property
    def seq(self) -> int:
        return len(self.records)

    def append(self, rtype: str, **payload: Any) -> dict:
        """Appends one fsync'd record, refreshes the snapshot (every
        ``SNAPSHOT_EVERY`` appends and at the run's boundaries), then fires
        the ``journal.append`` fault site (after the record is durable: a
        crash there proves the record survives).  A no-op on a read-only
        journal."""
        rec = {"seq": self.seq, "type": rtype, **payload}
        if self.readonly:
            return rec
        line = json.dumps(rec, sort_keys=True)
        # One journal[<type>] span per append: the fsync is wall time on
        # the driver's path, and the appends are what a flight dump
        # correlates the dispatches against.
        with _ttrace.span(f"journal[{rtype}]", "journal",
                          seq=rec["seq"], dir=self.directory):
            with open(self._path, "a", encoding="utf-8") as f:
                f.write(line + "\n")
                f.flush()
                os.fsync(f.fileno())
        # Process-global tally (the journal has no context): heartbeat
        # lines and metrics.json carry it under "process".
        _tmetrics.GLOBAL.inc("journal_appends")
        self.records.append(rec)
        self._unsnapshotted += 1
        if (
            self._unsnapshotted >= SNAPSHOT_EVERY
            or rtype in ("run_start", "run_done")
        ):
            self._unsnapshotted = 0
            durable_write_text(
                os.path.join(self.directory, SNAPSHOT_NAME),
                json.dumps(
                    {"version": JOURNAL_VERSION, "records": self.records},
                    sort_keys=True,
                )
                + "\n",
            )
        fault_point("journal.append")
        return rec

    # -- reading -----------------------------------------------------------

    def last(self, rtype: str) -> Optional[dict]:
        for rec in reversed(self.records):
            if rec.get("type") == rtype:
                return rec
        return None

    def of_type(self, rtype: str) -> List[dict]:
        return [r for r in self.records if r.get("type") == rtype]

    @property
    def config(self) -> Dict[str, Any]:
        return self.records[0]["config"] if self.records else {}

    @property
    def complete(self) -> bool:
        return self.last("run_done") is not None

    def load_checkpoint(self, filename: str):
        """Loads a checkpoint recorded by file name (against ``ckpt_root``
        when set)."""
        from ..graph.xmlio import load_state

        return load_state(os.path.join(self.ckpt_root or self.directory,
                                       filename))
