"""Several processes: the port's process group on ``torch.distributed``.

The reference scales across nodes with MPI (rank 0 drives, every rank
sweeps a static slice, sboxgates.c:619-642, lut.c:138-149); the JAX
package connects N processes with ``jax.distributed`` and runs the same
host driver in every one.  Here :func:`initialize` joins N processes into
one ``torch.distributed`` group through a ``tcp://`` init method, and every
process runs the same driver:

- the mesh of :mod:`.mesh` then spans every rank's local shards, shard d
  of rank r being global shard ``r * local + d``;
- host control stays in lockstep because every verdict the sweeps return
  is exchanged (identical on every rank) and the PRNG is seeded the same
  everywhere (:func:`shared_seed`: rank 0's seed, broadcast);
- only rank 0 (:func:`is_primary`) writes checkpoints and logs.

Two planes.  The control plane is the group's key-value store (a
``TCPStore``): the replicated degradation protocol's verdicts
(:func:`breach_verdict`), the journal's round check
(:func:`journal_seq_check`), the start-up agreement on the run
configuration (:func:`run_config_check`), the seed broadcast and the
native-route agreement ride it, each exchange bounded by the store's own
wait timeout, so a killed peer or a wedged collective never blocks them.
The data plane (the sweeps' per-window all-reduce and their verdict and
row gathers) runs on the group's collectives: gloo on the CPU, and also on
CUDA when two ranks share a card (NCCL refuses two ranks on one GPU);
NCCL when every rank owns its own card(s).  The rule is logged in one
line; a failed NCCL set-up is an error, never a quiet switch to gloo.  A
replicated abort renews the data group on every rank (:func:`renew`),
so a retry never meets the collectives of the window it abandoned.

With one process (no :func:`initialize`) every function here is a no-op
that answers for rank 0 of 1.
"""

from __future__ import annotations

import datetime
import logging
import os
import sys
import threading
from typing import Callable, List, Optional

import numpy as np

logger = logging.getLogger(__name__)

#: The group's state: rank, world size, control store, data group and its
#: backend.
_STATE = {"rank": 0, "world": 1, "store": None, "group": None,
          "backend": None}

#: Deadline of the data plane's collectives (a wedged one is abandoned by
#: the replicated protocol long before this).
GROUP_TIMEOUT_S = 900.0


def rank() -> int:
    """This process's rank (0 without a group)."""
    return _STATE["rank"]


def world_size() -> int:
    """Processes in the group (1 without one)."""
    return _STATE["world"]


def is_primary() -> bool:
    """True on the process that owns side effects (checkpoints, logs):
    rank 0, the reference's rank 0."""
    return rank() == 0


def _card_ids(device_type: str) -> List[str]:
    """Identities of the cards this process sees (their UUIDs), for the
    backend rule."""
    if device_type != "cuda":
        return []
    import torch

    out = []
    for i in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(i)
        out.append(str(getattr(props, "uuid", f"{props.name}:{i}")))
    return out


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: str = "cpu",
) -> None:
    """Joins this process into the group: ``coordinator_address``
    (HOST:PORT of rank 0), ``num_processes`` and ``process_id`` default to
    the JAX package's variables ``JAX_COORDINATOR_ADDRESS``,
    ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``.  ``device`` ("cpu" or
    "cuda") picks the data plane's backend by the rule of the module
    docstring, logged in one line on standard error."""
    import torch.distributed as dist

    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None or num_processes is None or (
        process_id is None
    ):
        raise ValueError(
            "a process group needs --coordinator HOST:PORT, --num-processes "
            "and --process-id (or JAX_COORDINATOR_ADDRESS, "
            "JAX_NUM_PROCESSES and JAX_PROCESS_ID)"
        )
    n, r = int(num_processes), int(process_id)
    if not 0 <= r < n:
        raise ValueError(f"process id {r} is not in [0, {n})")
    device_type = str(device).split(":")[0]
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    # The default group is gloo: its store is the control plane, and its
    # collectives need no card.
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}", world_size=n,
        rank=r, timeout=timeout,
    )
    from torch.distributed import distributed_c10d as _c10d

    store = _c10d._get_default_store()
    _STATE.update(rank=r, world=n, store=store)
    ids = _card_ids(device_type)
    store.set(f"sbg/cards/{r}", ",".join(ids))
    store.wait([f"sbg/cards/{i}" for i in range(n)], timeout)
    seen: dict = {}
    shared = False
    for i in range(n):
        for c in store.get(f"sbg/cards/{i}").decode().split(","):
            if c and seen.setdefault(c, i) != i:
                shared = True
    if device_type != "cuda":
        chosen, why = "gloo", "CPU ranks"
    elif shared:
        chosen, why = "gloo", "ranks share a card (NCCL refuses two ranks "\
            "on one GPU)"
    else:
        chosen, why = "nccl", "every rank owns its own card(s)"
    _STATE["backend"] = chosen
    _STATE["group"] = _new_group(chosen)
    print(f"sboxgates_tpu_torch: process group rank {r} of {n}, "
          f"collectives on {chosen}: {why}", file=sys.stderr, flush=True)
    # Rank-targeted fault sites and the telemetry's rank tags follow the
    # group's rank from here on.
    from ..resilience import faults
    from ..telemetry import trace as _ttrace

    faults.set_rank(r)
    _ttrace.set_rank(r)


def _new_group(chosen: str):
    import torch.distributed as dist

    return dist.new_group(
        backend=chosen, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    )


def shutdown() -> None:
    """Leaves the group (every rank, after the exit barrier): its
    communicators are torn down before the interpreter exits."""
    import torch.distributed as dist

    if _STATE["store"] is None:
        return
    try:
        dist.destroy_process_group()
    except RuntimeError as e:  # a peer that died already
        logger.warning("process group teardown: %s", e)
    _STATE.update(rank=0, world=1, store=None, group=None, backend=None)
    from ..resilience import faults
    from ..telemetry import trace as _ttrace

    faults.set_rank(None)
    _ttrace.set_rank(None)


def renew() -> None:
    """A fresh data group on every rank (called in lockstep after an
    agreed abort): the abandoned window's collectives stay on the old
    group, where nothing will ever match them."""
    if world_size() <= 1:
        return
    _STATE["group"] = _new_group(_STATE["backend"])


# -- data plane -----------------------------------------------------------


def _data_tensor(values, dtype):
    """The collective's buffer; refuses a collective of an attempt the
    deadline has abandoned (its peers have moved to a renewed group)."""
    import torch

    from ..resilience.deadline import DispatchTimeout, current_attempt

    att = current_attempt()
    if att is not None and att.abandoned:
        raise DispatchTimeout("collective of an abandoned attempt")

    # torchlint: ignore[R2x] the collective's operand arrives as host values (Python ints, numpy arrays); the copy is the upload, not a device pull
    t = torch.as_tensor(np.asarray(values), dtype=dtype)
    if _STATE["backend"] == "nccl":
        t = t.to(f"cuda:{torch.cuda.current_device()}")
    return t


def all_reduce_min(value: int) -> int:
    """The minimum of one int over every rank (one collective)."""
    if world_size() <= 1:
        return int(value)
    import torch
    import torch.distributed as dist

    t = _data_tensor([value], torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=_STATE["group"])
    # torchlint: ignore[R2x] the collective's one-int result: the all-reduce is the ranks' agreement point and waits for every rank regardless
    return int(t.cpu()[0])


def all_reduce_max(value: int) -> int:
    """The maximum of one int over every rank (one collective)."""
    if world_size() <= 1:
        return int(value)
    import torch
    import torch.distributed as dist

    t = _data_tensor([value], torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_STATE["group"])
    # torchlint: ignore[R2x] the collective's one-int result: the all-reduce is the ranks' agreement point and waits for every rank regardless
    return int(t.cpu()[0])


def all_gather_array(arr: np.ndarray) -> np.ndarray:
    """Every rank's equally-shaped ``arr`` stacked in rank order (one
    collective): [world, *arr.shape]."""
    arr = np.ascontiguousarray(arr)
    if world_size() <= 1:
        return arr[None]
    import torch
    import torch.distributed as dist

    # Flags travel as bytes (NCCL has no bool type).
    wire = arr.view(np.uint8) if arr.dtype == np.bool_ else arr
    src = _data_tensor(wire, torch.from_numpy(wire[:0]).dtype)
    out = [torch.empty_like(src) for _ in range(world_size())]
    dist.all_gather(out, src, group=_STATE["group"])
    return np.stack([o.cpu().numpy() for o in out]).view(arr.dtype)


# -- control plane --------------------------------------------------------

#: journal_seq_check call counter: unique per call, identical across ranks
#: (the calls are lockstep round boundaries).
_SEQCHECK_SEQ = 0
#: Verdict-barrier sequence number, one per guarded window on every rank.
_VERDICT_SEQ = 0
_VERDICT_LOCK = threading.Lock()
#: Exchange sequence of the seed and native-route agreements.
_AGREE_SEQ = 0
#: The round check's wait (the JAX package's ``journal_seq_check``
#: default ``timeout_s=600``).
_SEQCHECK_TIMEOUT_S = 600.0
#: The start-up agreements' wait: the run-config check (the JAX
#: package's ``run_config_check`` default ``timeout_s=120``), the seed
#: and the native-route agreements.
_STARTUP_TIMEOUT_S = 120.0


def _kv_exchange(tag: str, seq: int, payload: Optional[str],
                 timeout_s: float,
                 fold: Optional[Callable[[List[str]], str]] = None) -> str:
    """One agreement round on the store, shared by every control-plane
    exchange so their transport semantics cannot drift (the JAX package's
    ``_kv_exchange`` on its coordination service):

    - ``fold=None``: the primary publishes ``payload`` under
      ``sbg/<tag>/<seq>`` (the others pass None), everyone waits for it;
    - ``fold``: every rank publishes its part, the primary folds the
      parts into the round's one value, everyone reads that.

    One deadline of ``timeout_s`` bounds the whole exchange; running out
    raises ``TimeoutError``.  The primary deletes round ``seq - 1``'s keys
    once this round's parts are in (every rank has read them by then)."""
    import time

    store = _STATE["store"]
    r, n = rank(), world_size()
    deadline = time.monotonic() + max(timeout_s, 1e-3)

    def remaining() -> datetime.timedelta:
        left = deadline - time.monotonic()
        if left <= 0:
            raise TimeoutError(
                f"{tag} round {seq}: exchange budget ({timeout_s:g}s) "
                "exhausted"
            )
        return datetime.timedelta(seconds=left)

    key = f"sbg/{tag}/{seq}"
    try:
        if fold is not None:
            store.set(f"{key}/part/{r}", payload)
            if r == 0:
                parts = [f"{key}/part/{i}" for i in range(n)]
                store.wait(parts, remaining())
                store.set(key, fold([store.get(p).decode() for p in parts]))
        elif payload is not None:
            store.set(key, payload)
        store.wait([key], remaining())
        out = store.get(key).decode()
        if r == 0 and seq > 1:
            prev = f"sbg/{tag}/{seq - 1}"
            try:
                store.delete_key(prev)
                if fold is not None:
                    for i in range(n):
                        store.delete_key(f"{prev}/part/{i}")
            except RuntimeError:
                pass
        return out
    except RuntimeError as e:
        # The store's own wait timeout (a peer that never came).
        raise TimeoutError(f"{tag} round {seq}: {e}") from e


def journal_seq_check(round_idx: int, seq: Optional[int] = None) -> None:
    """Resume lockstep at a round boundary: the primary publishes its
    (round, journal sequence number) and every rank checks the round
    against its own.  A desync (one rank resumed from a stale directory)
    fails here, loudly, not in the next collective.  On the store, so a
    pod degraded to its host drivers still reaches it.  No-op with one
    process."""
    global _SEQCHECK_SEQ
    if world_size() <= 1:
        return
    with _VERDICT_LOCK:
        _SEQCHECK_SEQ += 1
        n = _SEQCHECK_SEQ
    payload = (f"{round_idx}:{-1 if seq is None else seq}"
               if is_primary() else None)
    try:
        got = _kv_exchange("journal-seq", n, payload, _SEQCHECK_TIMEOUT_S)
    except TimeoutError as e:
        raise RuntimeError(
            f"multi-host journal seq-check at round {round_idx} could not "
            f"complete ({e}); a peer is unreachable — the pod cannot "
            "continue its lockstep rounds"
        ) from e
    prim_round, prim_seq = (int(x) for x in got.split(":"))
    if prim_round != round_idx:
        raise RuntimeError(
            f"multi-host journal desync: the primary is at round "
            f"{prim_round} (journal seq {prim_seq}) but this process is at "
            f"round {round_idx}; resume every process against the same run "
            "directory state"
        )


def breach_verdict(local_breach: bool, timeout_s: float) -> bool:
    """The replicated abort agreement of one guarded window: breach iff
    any rank breached.  Every rank publishes its flag, the primary folds,
    every rank reads the one verdict within ``timeout_s`` (the caller's
    ``deadline.verdict_transport_timeout``; the JAX package's default of
    10 s is never reached).  A failure to complete the exchange
    (a killed rank, a dead store) is itself the breach signal.  One
    process: the local flag."""
    global _VERDICT_SEQ
    if world_size() <= 1:
        return bool(local_breach)
    with _VERDICT_LOCK:
        _VERDICT_SEQ += 1
        seq = _VERDICT_SEQ
    from ..telemetry import trace as _ttrace

    _ttrace.instant("verdict.exchange", "deadline", seq=seq,
                    local_breach=local_breach)
    try:
        agreed = _kv_exchange(
            "verdict", seq, "1" if local_breach else "0", timeout_s,
            fold=lambda parts: "1" if any(p == "1" for p in parts) else "0",
        )
    except TimeoutError as e:
        logger.warning("verdict exchange %d failed (%s); agreeing on breach",
                       seq, e)
        return True
    return agreed == "1"


def run_config_check(digest: str) -> None:
    """Start-up agreement: every rank runs the primary's journaled
    configuration (its digest), or the run fails here, before any
    collective or slice work.  No-op with one process."""
    if world_size() <= 1:
        return
    try:
        primary = _kv_exchange("run-config", 1,
                               digest if is_primary() else None,
                               _STARTUP_TIMEOUT_S)
    except TimeoutError as e:
        raise RuntimeError(
            f"multi-host run-config agreement could not complete ({e}); a "
            "peer is unreachable"
        ) from e
    if primary != digest:
        raise RuntimeError(
            "multi-host run-config desync: this process's journaled "
            "configuration differs from the primary's; resume every "
            "process against the same run directory"
        )


def _agree(tag: str, payload: Optional[str], fold=None) -> str:
    global _AGREE_SEQ
    with _VERDICT_LOCK:
        _AGREE_SEQ += 1
        n = _AGREE_SEQ
    return _kv_exchange(f"{tag}-{n}", 1, payload, _STARTUP_TIMEOUT_S,
                        fold=fold)


def shared_seed(seed: Optional[int]) -> Optional[int]:
    """A seed every rank agrees on: an explicit one as is, else rank 0
    draws one and broadcasts it (differently-seeded ranks would take
    divergent control decisions and deadlock the collective sweeps)."""
    if seed is not None or world_size() <= 1:
        return seed
    local = (str(int(np.uint32(np.random.SeedSequence().generate_state(1)[0])))
             if is_primary() else None)
    return int(_agree("seed", local))


def all_agree(flag: bool) -> bool:
    """True when ``flag`` holds on every rank (the native-route
    agreement; every rank must call it at the same point)."""
    if world_size() <= 1:
        return bool(flag)
    return _agree(
        "all", "1" if flag else "0",
        fold=lambda parts: "1" if all(p == "1" for p in parts) else "0",
    ) == "1"


def barrier(tag: str, timeout_s: float = 120.0) -> None:
    """Every rank reaches ``tag`` (on the store: usable after the data
    plane was written off).  Rank 0, which hosts the store, returns only
    after every other rank has finished with it, so it may exit at once.
    Raises ``TimeoutError`` when a rank does not come in time."""
    global _AGREE_SEQ
    if world_size() <= 1:
        return
    with _VERDICT_LOCK:
        _AGREE_SEQ += 1
        n = _AGREE_SEQ
    store, r, w = _STATE["store"], rank(), world_size()
    key = f"sbg/barrier/{tag}/{n}"
    timeout = datetime.timedelta(seconds=timeout_s)
    try:
        store.set(f"{key}/in/{r}", "1")
        if r == 0:
            store.wait([f"{key}/in/{i}" for i in range(w)], timeout)
            store.set(f"{key}/go", "1")
            store.wait([f"{key}/out/{i}" for i in range(1, w)], timeout)
        else:
            store.wait([f"{key}/go"], timeout)
            store.set(f"{key}/out/{r}", "1")
    except RuntimeError as e:
        raise TimeoutError(f"barrier {tag}: {e}") from e
