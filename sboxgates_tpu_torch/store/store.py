"""The content-addressed global result store (``--result-store DIR``).

The JAX package's ``store/store.py`` on the port's state, XML and
resilience modules: the same layout, entry bytes and keys
(:mod:`..core.canon`), so a store written by either package serves hits
to the other.

One level up from the digest-keyed device-table and compile caches: a
DURABLE store of finished, verified circuit graphs — and the per-round
frontier of interrupted searches — keyed on the CANONICAL form of
``(target, mask, metric)`` (:mod:`sboxgates_tpu_torch.core.canon`).  At
millions-of-users scale most submitted targets are not novel; the store
turns the engine from "compute per query" into "compute per NOVEL
query": a repeat query is answered from disk in milliseconds with zero
device dispatches, a repeat of an interrupted search resumes from the
stored frontier, and ReducedLUT-style decomposition sub-tables published
by one tenant's search serve every later tenant.

Layout (all writes tmp + fsync + atomic-replace, the checkpoint
durability discipline)::

    DIR/objects/<kk>/<key>.json          # circuit entries (key = canon digest)
    DIR/objects/<kk>/<fkey>.json         # frontier entries (exact frame + config)
    DIR/index.jsonl                      # advisory append-only listing
    DIR/quarantine/                      # corrupt entries, moved aside

Every entry embeds a SHA-256 over its body; a torn, truncated, or
digest-corrupt entry is treated as a MISS and moved to ``quarantine/``
— never a crash, never a wrong answer.  Full hits are additionally
re-verified against the ORIGINAL (uncanonicalized) query table over all
2^8 inputs after the frame rewrite, so even a store bug degrades to
miss-and-search.  ``index.jsonl`` is observability only — the
content-addressed object path IS the index, so a lost or corrupt index
costs nothing.

Chaos sites (``resilience.faults``): ``store.get`` entering a lookup,
``store.put`` before an entry write, ``store.index`` before an index
append.  An injected raise at any of them degrades (miss / skipped
publish / skipped index line) — the store never takes a search down.

Writes ride one background writer thread (:meth:`ResultStore._work`),
so publishing never blocks a search's completion path on an fsync;
:meth:`flush` drains it, :meth:`close` drains and stops it.  An unwritable or
read-only directory degrades the store to read-only mode with one
logged note — lookups keep working, publishes become no-ops.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..core import canon
from ..core import ttable as tt
from ..graph.state import NO_GATE, State
from ..graph.xmlio import state_from_xml, state_to_xml
from ..resilience.checkpoint import clean_stale_tmp, durable_write_text
from ..resilience.faults import (
    InjectedFault,
    current_job,
    fault_point,
    set_job,
)
from .rewrite import RewriteError, rewrite_state

logger = logging.getLogger(__name__)

#: Entry-format version; unknown versions read as a miss, not an error.
ENTRY_VERSION = 1

#: Most sub-table entries published per circuit (largest cones first).
SUB_ENTRY_CAP = 8


@dataclass
class StoreHit:
    """One full hit: the stored circuit rewritten into the QUERY frame
    and re-verified against the original query."""

    state: State
    key: str
    meta: dict = field(default_factory=dict)
    #: True when the composed rewrite was the identity — the returned
    #: graph is byte-identical to the published one.
    exact_frame: bool = True


class ResultStore:
    """Durable content-addressed result store; see the module docstring.

    ``stats`` (a ``telemetry.metrics.MetricsRegistry``) receives the
    declared ``store_*`` counters and the ``store_get_s`` histogram;
    None keeps the store silent.  ``sync`` forces writes inline
    (subprocess tests that exit immediately after a put)."""

    def __init__(self, root: str, stats=None, readonly: bool = False,
                 sync: bool = False):
        self.root = root
        self.stats = stats
        self._lock = threading.Lock()
        self.readonly = bool(readonly)
        if not self.readonly:
            try:
                os.makedirs(os.path.join(root, "objects"), exist_ok=True)
                if not os.access(root, os.W_OK):
                    raise OSError(f"{root} is not writable")
                for sub in self._object_dirs():
                    clean_stale_tmp(sub)
            except OSError as e:
                # The satellite degradation contract: an unwritable
                # store serves lookups read-only with one logged note.
                logger.warning(
                    "result store %s is not writable (%s); degrading to "
                    "read-only mode", root, e,
                )
                self.readonly = True
        self._queue: Optional["queue.Queue"] = None
        self._thread: Optional[threading.Thread] = None
        if not self.readonly and not sync:
            self._queue = queue.Queue()
            self._thread = threading.Thread(
                target=self._work, name="sbg-store-writer", daemon=True
            )
            self._thread.start()

    # -- plumbing ----------------------------------------------------------

    def _object_dirs(self) -> List[str]:
        base = os.path.join(self.root, "objects")
        try:
            # Sorted: index rebuilds and sweeps must visit shards in the
            # same order on every platform/filesystem.
            return [
                os.path.join(base, d) for d in sorted(os.listdir(base))
                if os.path.isdir(os.path.join(base, d))
            ]
        except OSError:
            return []

    def _path(self, key: str) -> str:
        return os.path.join(
            self.root, "objects", key[-2:], f"{key}.json"
        )

    def _inc(self, name: str, by: float = 1) -> None:
        if self.stats is not None:
            self.stats.inc(name, by)

    def _observe(self, name: str, v: float) -> None:
        if self.stats is not None:
            self.stats.observe(name, v)

    def _work(self) -> None:
        """The background writer: drains queued publish closures.  A
        failed write is logged and dropped — publishing is best-effort
        by contract (the search result is already safe on the caller's
        side)."""
        q = self._queue  # close() nulls the attribute; the local keeps
        while True:      # draining until the sentinel arrives
            item = q.get()
            if item is None:
                return
            try:
                item()
            except Exception as e:
                logger.warning("result store write failed: %r", e)

    def _submit(self, fn) -> None:
        # The caller's @job:ID fault pin rides onto the writer thread,
        # so store.put stays job-targetable through the async path.
        job = current_job()
        if self._queue is not None:
            def run() -> None:
                set_job(job)
                try:
                    fn()
                finally:
                    set_job(None)

            self._queue.put(run)
            return
        try:
            fn()
        except Exception as e:
            logger.warning("result store write failed: %r", e)

    def flush(self) -> None:
        """Blocks until every queued write has landed."""
        if self._queue is None:
            return
        done = threading.Event()
        self._queue.put(done.set)
        done.wait(30.0)

    def close(self) -> None:
        """Drains and stops the writer thread; idempotent."""
        with self._lock:
            q, t = self._queue, self._thread
            self._queue, self._thread = None, None
        if q is not None:
            q.put(None)
        if t is not None:
            t.join(30.0)

    # -- entry files -------------------------------------------------------

    def _quarantine(self, path: str) -> None:
        qdir = os.path.join(self.root, "quarantine")
        try:
            os.makedirs(qdir, exist_ok=True)
            # torchlint: ignore[R12] rename of already-durable bytes — no content is written, so there is nothing to tear
            os.replace(path, os.path.join(qdir, os.path.basename(path)))
            self._inc("store_corrupt_quarantined")
            logger.warning(
                "result store: corrupt entry %s quarantined", path
            )
        except OSError:
            logger.warning(
                "result store: corrupt entry %s could not be "
                "quarantined; treating as a miss", path,
            )

    def _load_entry(self, path: str) -> Optional[dict]:
        """The entry body, or None (missing / torn / digest-corrupt —
        corrupt files are quarantined, never fatal)."""
        try:
            with open(path, "r", encoding="utf-8") as f:
                raw = f.read()
        except OSError:
            return None
        try:
            doc = json.loads(raw)
            body = doc["body"]
            recorded = doc["sha256"]
        except (ValueError, KeyError, TypeError):
            self._quarantine(path)
            return None
        if doc.get("v") != ENTRY_VERSION:
            # An unknown (e.g. newer) entry version is a plain MISS,
            # never quarantine: stores are shared across builds, and an
            # older reader must not destroy an entry a newer build can
            # read.
            return None
        digest = hashlib.sha256(
            json.dumps(body, sort_keys=True).encode()
        ).hexdigest()
        if digest != recorded:
            self._quarantine(path)
            return None
        return body

    def _write_entry(self, key: str, body: dict) -> bool:
        """Durably publishes one entry; keep-first (the first publisher
        of a key wins — repeat queries then get byte-stable answers).
        Returns False when the key already existed."""
        path = self._path(key)
        with self._lock:
            if os.path.exists(path):
                return False
            fault_point("store.put")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            doc = {
                "v": ENTRY_VERSION,
                "sha256": hashlib.sha256(
                    json.dumps(body, sort_keys=True).encode()
                ).hexdigest(),
                "body": body,
            }
            durable_write_text(path, json.dumps(doc, sort_keys=True))
        self._inc("store_puts")
        self._append_index(key, body.get("kind", "?"))
        return True

    def _append_index(self, key: str, kind: str) -> None:
        """Advisory listing line (observability; the object path is the
        real index) — any failure here is logged and ignored."""
        try:
            fault_point("store.index")
            with self._lock:
                with open(
                    os.path.join(self.root, "index.jsonl"), "a",
                    encoding="utf-8",
                ) as f:
                    f.write(json.dumps(
                        {"key": key, "kind": kind, "t": time.time()}
                    ) + "\n")
        except (OSError, InjectedFault) as e:
            logger.warning("result store index append failed: %r", e)

    # -- lookups -----------------------------------------------------------

    def fetch(self, target, mask, metric: int,
               frontier_cfg: Optional[dict] = None):
        """One single-output query: ``("hit", StoreHit)`` for a full
        circuit hit, ``("partial", frontier_body)`` when only an
        interrupted-search frontier matches (``frontier_cfg`` given),
        else ``("miss", None)``.  Counts store_hits /
        store_partial_hits / store_misses disjointly and observes the
        end-to-end latency into ``store_get_s``.  Never raises: every
        failure shape (injected fault, torn entry, failed rewrite,
        failed verification) degrades to a miss."""
        t0 = time.perf_counter()
        try:
            fault_point("store.get")
            hit = self._lookup_full(target, mask, metric)
            if hit is not None:
                self._inc("store_hits")
                return "hit", hit
            if frontier_cfg is not None:
                fr = self._lookup_frontier(
                    target, mask, metric, frontier_cfg
                )
                if fr is not None:
                    self._inc("store_partial_hits")
                    return "partial", fr
        except InjectedFault as e:
            logger.warning("result store lookup fault (%s); miss", e)
        except (OSError, ValueError, KeyError, RewriteError) as e:
            logger.warning("result store lookup failed (%r); miss", e)
        finally:
            self._observe("store_get_s", time.perf_counter() - t0)
        self._inc("store_misses")
        return "miss", None

    def fetch_multi(self, targets, mask, metric: int,
                     frontier_cfg: Optional[dict] = None):
        """The all-outputs variant: exact-key only (see
        ``canon.exact_multi_key``), every bound output verified."""
        t0 = time.perf_counter()
        try:
            fault_point("store.get")
            key = canon.exact_multi_key(targets, mask, metric)
            body = self._load_entry(self._path(key))
            if body is not None and body.get("kind") == "circuit":
                st = state_from_xml(body["circuit"])
                mask_w = np.asarray(mask, dtype=np.uint32)
                ok = all(
                    st.outputs[bit] != NO_GATE
                    and bool(tt.eq_mask(
                        st.tables[st.outputs[bit]],
                        np.asarray(targets[bit], dtype=np.uint32),
                        mask_w,
                    ))
                    for bit in range(len(targets))
                )
                if ok:
                    self._inc("store_hits")
                    return "hit", StoreHit(
                        st, key, dict(body.get("meta", {}))
                    )
                logger.warning(
                    "result store: entry %s failed re-verification; "
                    "treating as a miss", key,
                )
            if frontier_cfg is not None:
                fr = self._lookup_frontier(
                    None, mask, metric, frontier_cfg, multi=targets
                )
                if fr is not None:
                    self._inc("store_partial_hits")
                    return "partial", fr
        except InjectedFault as e:
            logger.warning("result store lookup fault (%s); miss", e)
        except (OSError, ValueError, KeyError) as e:
            logger.warning("result store lookup failed (%r); miss", e)
        finally:
            self._observe("store_get_s", time.perf_counter() - t0)
        self._inc("store_misses")
        return "miss", None

    def _lookup_full(self, target, mask, metric: int) -> Optional[StoreHit]:
        target = np.asarray(target, dtype=np.uint32)
        mask = np.asarray(mask, dtype=np.uint32)
        key, t_q = canon.canonicalize(target, mask, metric)
        body = self._load_entry(self._path(key))
        if body is None or body.get("kind") != "circuit":
            return None
        st = state_from_xml(body["circuit"])
        tr = body.get("transform")
        if (tr is None) != (t_q is None):
            return None  # key kinds can never mix, but stay defensive
        exact_frame = True
        if t_q is not None:
            t_pub = canon.Transform(
                tuple(tr["perm"]), tuple(tr["neg"]), int(tr["comp"])
            )
            r = canon.compose(canon.invert(t_q), t_pub)
            if not r.is_identity():
                exact_frame = False
                st = rewrite_state(st, r)
        # The safety net: whatever the canonicalization and rewrite did,
        # the returned circuit must realize the ORIGINAL query table on
        # every input the mask cares about — all 2^8 positions checked.
        gid = st.outputs[0]
        if gid == NO_GATE or not bool(
            tt.eq_mask(st.tables[gid], target, mask)
        ):
            logger.warning(
                "result store: entry %s failed re-verification against "
                "the query; treating as a miss", key,
            )
            return None
        return StoreHit(st, key, dict(body.get("meta", {})), exact_frame)

    # -- publishing --------------------------------------------------------

    def put_state(self, st: State, target, mask, metric: int,
                  output: int = 0, sub_tables: bool = False,
                  meta: Optional[dict] = None) -> None:
        """Publishes one finished single-output circuit (the value is
        normalized to bind output bit 0; hits rebind to the querying
        bit).  ``sub_tables`` also publishes the LUT-decomposition
        sub-circuits as shared entries (:data:`SUB_ENTRY_CAP` largest
        cones).  Asynchronous and best-effort: failures are logged,
        never raised into the search."""
        if self.readonly:
            return
        gid = st.outputs[output]
        if gid == NO_GATE:
            return
        target = np.asarray(target, dtype=np.uint32).copy()
        mask = np.asarray(mask, dtype=np.uint32).copy()
        entry_st = _rebind(st, gid)
        meta = dict(meta or {})
        subs: List[State] = (
            _sub_states(st, SUB_ENTRY_CAP) if sub_tables else []
        )

        def write() -> None:
            self._put_single(entry_st, target, mask, metric, meta)
            for sub in subs:
                sub_target = sub.tables[sub.outputs[0]]
                self._put_single(
                    sub, sub_target, mask, metric,
                    dict(meta, sub_table=True),
                )

        self._submit(write)

    def put_multi(self, st: State, targets, mask, metric: int,
                  sub_tables: bool = False,
                  meta: Optional[dict] = None) -> None:
        """Publishes a finished ALL-outputs circuit under its exact
        multi key, plus one single-output entry per bound output (the
        output's cone — so a later one-output query for any bit of this
        S-box, in any equivalent frame, hits) and optionally the LUT
        sub-tables."""
        if self.readonly:
            return
        targets = [np.asarray(t, dtype=np.uint32).copy() for t in targets]
        mask = np.asarray(mask, dtype=np.uint32).copy()
        meta = dict(meta or {})
        st = st.copy()
        subs: List[State] = (
            _sub_states(st, SUB_ENTRY_CAP) if sub_tables else []
        )

        def write() -> None:
            try:
                fault_point("store.put")
            except InjectedFault as e:
                logger.warning("result store put fault (%s); skipped", e)
                return
            key = canon.exact_multi_key(targets, mask, metric)
            body = {
                "kind": "circuit",
                "key": key,
                "metric": int(metric),
                "transform": None,
                "circuit": state_to_xml(st),
                "meta": meta,
            }
            try:
                self._write_entry(key, body)
            except (OSError, InjectedFault) as e:
                logger.warning("result store put failed (%r)", e)
            for bit in range(len(targets)):
                gid = st.outputs[bit]
                if gid == NO_GATE:
                    continue
                self._put_single(
                    _cone_state(st, gid), targets[bit], mask, metric,
                    dict(meta, output_bit=bit),
                )
            for sub in subs:
                self._put_single(
                    sub, sub.tables[sub.outputs[0]], mask, metric,
                    dict(meta, sub_table=True),
                )

        self._submit(write)

    def _put_single(self, st: State, target, mask, metric: int,
                    meta: dict) -> None:
        """One normalized (output-bit-0) circuit entry; canonical key +
        recorded publisher transform.  All failure shapes degrade to a
        skipped publish."""
        try:
            key, t_pub = canon.canonicalize(target, mask, metric)
            body = {
                "kind": "circuit",
                "key": key,
                "metric": int(metric),
                "transform": (
                    None if t_pub is None else {
                        "perm": list(t_pub.perm),
                        "neg": list(t_pub.neg),
                        "comp": t_pub.comp,
                    }
                ),
                "circuit": state_to_xml(st),
                "meta": meta,
            }
            self._write_entry(key, body)
        except (OSError, InjectedFault) as e:
            logger.warning("result store put failed (%r)", e)

    # -- frontiers (interrupted searches) ----------------------------------

    def _frontier_key(self, target, mask, metric: int, cfg: dict,
                      multi=None) -> str:
        """Frontier entries are EXACT-frame by contract: the journal
        snapshot embeds PRNG state, which does not commute with frame
        rewrites — so the key binds the exact target digest AND the
        draw-shaping configuration digest."""
        if multi is not None:
            base = canon.exact_multi_key(multi, mask, metric)
        else:
            base = canon.exact_key(target, mask, metric)
        cfg_digest = hashlib.blake2b(
            json.dumps(cfg, sort_keys=True, default=str).encode(),
            digest_size=12,
        ).hexdigest()
        return f"f-{base}-{cfg_digest}"

    def put_frontier(self, target, mask, metric: int, cfg: dict,
                     records: List[dict], checkpoints: Dict[str, str],
                     multi=None, meta: Optional[dict] = None) -> None:
        """Publishes the per-round frontier of an interrupted search:
        the journal's progress records (the journal's snapshot format —
        beam membership, budget ratchets, exact PRNG position) plus the
        checkpoint XML bodies they reference.  A later equivalent query
        with the SAME seed/configuration seeds its search from this
        frontier and finishes bit-identically to an uninterrupted
        run."""
        if self.readonly or not records:
            return
        key = self._frontier_key(target, mask, metric, cfg, multi=multi)
        body = {
            "kind": "frontier",
            "key": key,
            "metric": int(metric),
            "cfg": dict(cfg),
            "records": list(records),
            "checkpoints": dict(checkpoints),
            "meta": dict(meta or {}),
        }

        def write() -> None:
            try:
                # Frontiers overwrite-forward: a LATER frontier of the
                # same search strictly extends the earlier one (same
                # deterministic prefix), so last-writer-wins is safe and
                # resumes from the furthest published point.
                path = self._path(key)
                fault_point("store.put")
                with self._lock:
                    os.makedirs(os.path.dirname(path), exist_ok=True)
                    doc = {
                        "v": ENTRY_VERSION,
                        "sha256": hashlib.sha256(json.dumps(
                            body, sort_keys=True
                        ).encode()).hexdigest(),
                        "body": body,
                    }
                    durable_write_text(
                        path, json.dumps(doc, sort_keys=True)
                    )
                self._inc("store_puts")
                self._append_index(key, "frontier")
            except (OSError, InjectedFault) as e:
                logger.warning("result store frontier put failed (%r)", e)

        self._submit(write)

    def _lookup_frontier(self, target, mask, metric: int, cfg: dict,
                         multi=None) -> Optional[dict]:
        key = self._frontier_key(target, mask, metric, cfg, multi=multi)
        body = self._load_entry(self._path(key))
        if body is None or body.get("kind") != "frontier":
            return None
        # The key already binds the cfg digest; the full comparison
        # closes the (vanishing) digest-collision window.
        if json.dumps(body.get("cfg"), sort_keys=True, default=str) != \
                json.dumps(cfg, sort_keys=True, default=str):
            return None
        return body

    # -- introspection -----------------------------------------------------

    def status_view(self) -> dict:
        """Host-side store counters for /status and the serve queue
        view; zero device syncs."""
        s = self.stats
        return {
            "root": self.root,
            "readonly": self.readonly,
            "hits": int(s.get("store_hits", 0)) if s is not None else 0,
            "misses": (
                int(s.get("store_misses", 0)) if s is not None else 0
            ),
            "partial_hits": (
                int(s.get("store_partial_hits", 0))
                if s is not None else 0
            ),
            "puts": int(s.get("store_puts", 0)) if s is not None else 0,
        }


def _rebind(st: State, gid: int) -> State:
    """A copy with ONLY output bit 0 bound to ``gid`` — the normalized
    entry shape (hits rebind to the querying bit)."""
    out = st.copy()
    out.outputs = [NO_GATE] * 8
    out.outputs[0] = gid
    return out


def _cone_reachable(st: State, gid: int) -> List[int]:
    """Gate ids (sorted) reachable from ``gid`` through inputs,
    EXCLUDING the IN prefix."""
    n = st.num_inputs
    seen = set()
    stack = [gid]
    while stack:
        g = stack.pop()
        if g in seen or g < n:
            continue
        seen.add(g)
        gate = st.gates[g]
        for ref in (gate.in1, gate.in2, gate.in3):
            if ref != NO_GATE:
                stack.append(ref)
    return sorted(seen)


def _cone_state(st: State, gid: int) -> State:
    """The subcircuit realizing gate ``gid``: same IN prefix, only the
    cone's gates (original order), output bit 0 bound to the root."""
    n = st.num_inputs
    cone = _cone_reachable(st, gid)
    new = State.init_inputs(n)
    remap = {i: i for i in range(n)}
    for g in cone:
        gate = st.gates[g]
        remap[g] = new.replay_gate(
            gate.type,
            remap.get(gate.in1, NO_GATE) if gate.in1 != NO_GATE else NO_GATE,
            remap.get(gate.in2, NO_GATE) if gate.in2 != NO_GATE else NO_GATE,
            remap.get(gate.in3, NO_GATE) if gate.in3 != NO_GATE else NO_GATE,
            function=gate.function,
        )
    new.outputs[0] = remap[gid]
    return new


def _sub_states(st: State, cap: int) -> List[State]:
    """The ReducedLUT-style shared sub-entries: for each LUT gate whose
    cone holds at least two gates (a real decomposition sub-table, not
    a single-gate triviality), the cone as a standalone circuit —
    largest cones first, at most ``cap``."""
    from ..core import boolfunc as bf

    n = st.num_inputs
    cones = []
    for gid in range(n, st.num_gates):
        if st.gates[gid].type != bf.LUT:
            continue
        cone = _cone_reachable(st, gid)
        if len(cone) >= 2:
            cones.append((len(cone), gid))
    cones.sort(key=lambda c: (-c[0], c[1]))
    return [_cone_state(st, gid) for _, gid in cones[:cap]]
