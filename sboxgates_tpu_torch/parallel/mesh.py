"""Candidate-space parallelism over a mesh of shards.

The reference partitions the combination space statically over its MPI
ranks and races to the first hit (lut.c:138-149); the JAX package shards
each candidate chunk over a ``jax.sharding.Mesh`` axis and lets GSPMD add
the all-reduce of the found flag.  Here a mesh is a list of shards, each a
``torch.device``:

- ``--mesh`` takes every visible card (``torch.cuda.device_count()``, or
  the one CPU); ``SBG_LOCAL_SHARDS=N`` sets the local shard count instead,
  N shards taking the real devices in turn (so N shards may share one
  device: the counterpart of the JAX tests' virtual devices).  It changes
  no result: a run writes the JAX CLI's files at the same shard count;
- with a process group (:mod:`.distributed`) the mesh spans every rank's
  local shards, global shard ``rank * local + i``;
- the small operands are replicated (each shard's device gets a copy), the
  candidate space is split between the shards, and the streams stop at the
  end of the first round holding a hit in any shard, so the verdicts are
  the JAX package's mesh verdicts whatever the devices.

The sharded streams:

- :func:`sharded_pivot_stream`: lockstep rounds over the pivot tiles, shard
  d sweeping tile ``start_t + r * n + d`` in round r.  Each shard sweeps
  its rounds in windows of its own tiles with the pivot window kernel (K1,
  or K2 for ``--pivot-backend pre``) and the group takes one all-reduce
  per window;
- :func:`sharded_feasible_stream`: the feasibility stream, each shard
  sweeping a contiguous block of every chunk (K3 for 5-tuples), with the
  JAX package's compact gather across processes and its overflow re-drive
  (``SBG_GATHER_ROWS``);
- :func:`lut5_fused_step`, :func:`restart_batched_filter`: the fused
  filter + solve step and the restart-batched filter, plain torch, as the
  JAX package's are XLA sweeps.

The JAX package's pallas-to-XLA fallback tallies of its sharded stream
(``pivot_pallas_fallbacks``, ``filter_pallas_fallbacks``) have no
counterpart: the port's sharded stream runs the requested window kernel on
every shard and never falls back (the JAX package bumps them only for its
``SBG_PIVOT_BACKEND``/``SBG_FILTER_BACKEND`` pallas settings, which the
port does not read).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops import pivot_tile, sweeps
from . import distributed as dist

CANDIDATES_AXIS = "candidates"
JOBS_AXIS = "jobs"

#: The local shard count (default: the real devices).
LOCAL_SHARDS_ENV = "SBG_LOCAL_SHARDS"

#: The sharded pivot stream's collectives: ``windows`` swept,
#: ``window_reduces`` (the all-reduces, one per window on a spanning mesh),
#: ``gathers`` (verdict-row all-gathers, one per stream on a spanning
#: mesh).
COLLECTIVES = {"windows": 0, "window_reduces": 0, "gathers": 0}

_NO_HIT = 1 << 62
#: The solver rows of each tile the sharded pivot stream solves (the JAX
#: package's ``sharded_pivot_stream(solve_rows=64)``, which its one
#: caller never changes).
SHARDED_PIVOT_SOLVE_ROWS = 64


def gather_rows() -> int:
    """Rows each shard ships in the compact cross-process gather of the
    feasible stream (``SBG_GATHER_ROWS``, default 256; 1 forces the
    overflow re-drive)."""
    return int(os.environ.get("SBG_GATHER_ROWS", "256"))


def local_devices(device="cuda") -> List[torch.device]:
    """This process's shards: ``SBG_LOCAL_SHARDS`` of them (default one per
    real device of ``device``'s type), placed on the real devices in
    turn."""
    kind = torch.device(device).type
    real = torch.cuda.device_count() if kind == "cuda" else 1
    if kind == "cuda" and real == 0:
        raise RuntimeError("CUDA device requested but no card is visible")
    n = int(os.environ.get(LOCAL_SHARDS_ENV, "0") or 0) or real
    if kind == "cpu":
        return [torch.device("cpu")] * n
    return [torch.device("cuda", i % real) for i in range(n)]


class Mesh:
    """A grid of shards: ``local`` this process's shard devices, ``shape``
    the axis sizes, ``spans_processes`` when its collectives cross
    processes (``first`` is then this rank's first global shard)."""

    def __init__(self, local: Sequence[torch.device], axes: Dict[str, int],
                 spans_processes: bool):
        self.local = list(local)
        self.shape = dict(axes)
        self.spans_processes = spans_processes
        self.first = dist.rank() * len(self.local) if spans_processes else 0


def _check_uniform(local) -> None:
    """Every rank of a spanning mesh has the same local shards (the global
    shard numbering and the window schedule rely on it)."""
    mine = np.asarray([len(local), len(set(local))], np.int64)
    every = dist.all_gather_array(mine)
    if not (every == mine[None]).all():
        raise ValueError(
            "every process of a mesh needs the same local shard count; got "
            f"{every[:, 0].tolist()} shards on {every[:, 1].tolist()} devices"
        )


def make_mesh(devices: Optional[Sequence] = None, device="cuda") -> Mesh:
    """A candidate mesh: over ``devices`` (a local mesh), or by default over
    every rank's :func:`local_devices` (spanning the process group when
    there is one)."""
    spans = devices is None and dist.world_size() > 1
    local = list(devices) if devices is not None else local_devices(device)
    if spans:
        _check_uniform(local)
    n = len(local) * (dist.world_size() if spans else 1)
    return Mesh(local, {CANDIDATES_AXIS: n}, spans)


def make_fleet_mesh(devices: Sequence, candidates: int) -> Mesh:
    """A (jobs, candidates) mesh for the fleet over the local shards
    ``devices``: ``candidates`` shards per fleet lane, the rest on the job
    axis."""
    local = list(devices)
    n = len(local)
    if n % candidates:
        raise ValueError(f"{n} devices do not split into {candidates} "
                         "candidate shards")
    return Mesh(local, {JOBS_AXIS: n // candidates,
                        CANDIDATES_AXIS: candidates}, False)


class FleetPlan:
    """The fleet's (jobs, candidates) split (:func:`make_fleet_mesh`): the
    jobs buckets are multiples of ``n_job_shards``, as the JAX package
    pads its job axis for its mesh, which shapes the stacked steps' seed
    draws, and each lane-form launch of the fleet runs each job shard's
    block of lanes on that shard's devices (``ops/sweeps.py: job_shards``,
    the JAX package's ``shard_jobs``: ``P("jobs")``).  Job shard j owns the
    local shards ``local[j*C:(j+1)*C]`` (C candidate shards): with C > 1
    each of its launches is cut along the candidates (K3's 5-tuples, K1's
    window of tiles) into C contiguous pieces, piece c on local shard
    ``j*C + c``, as each fleet lane's candidate sweep partitions over
    ``"candidates"`` in the JAX package.  A process-spanning fleet is
    refused, as in the JAX package (a multi-process fleet runs
    ``--shard-sweep``: one local fleet per process)."""

    def __init__(self, mesh: Mesh):
        if mesh.spans_processes:
            raise ValueError(
                "fleet meshes must be process-local; use --shard-sweep "
                "to split a fleet across hosts"
            )
        self.mesh = mesh
        self.n_job_shards = mesh.shape[JOBS_AXIS]
        self.n_candidate_shards = mesh.shape[CANDIDATES_AXIS]
        c = self.n_candidate_shards
        #: Each job shard's first device (several shards may share one).
        self.job_devices = mesh.local[::c]
        #: Each job shard's C candidate shards' devices.
        self.candidate_devices = [mesh.local[j * c:(j + 1) * c]
                                  for j in range(self.n_job_shards)]


class MeshPlan:
    """The sharded streams' placement on a mesh: ``device`` (the first
    local shard's) holds the replicated operands and the gathered results;
    each stream copies the operands a shard needs to its device once."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.n_candidate_shards = mesh.shape[CANDIDATES_AXIS]
        self.spans_processes = mesh.spans_processes
        self.local = mesh.local
        self.first = mesh.first
        self.device = self.local[0]
        per_dev: Dict[torch.device, int] = {}
        for d in self.local:
            per_dev[d] = per_dev.get(d, 0) + 1
        #: Shards sharing the busiest device (the window cap divides by it).
        self.shards_per_device = max(per_dev.values())

    def shards(self):
        """(global shard index, device) of each local shard."""
        return [(self.first + i, d) for i, d in enumerate(self.local)]

    def shard_chunk(self, arr, fill=0) -> torch.Tensor:
        """A [N, ...] candidate array padded with ``fill`` rows to a shard
        multiple (0 for combination rows, all-ones for constraint rows:
        inert either way), on :attr:`device`; shard d's rows are block d."""
        arr = np.asarray(arr)
        n, s = arr.shape[0], self.n_candidate_shards
        if n % s:
            arr = np.concatenate(
                [arr, np.full((s - n % s,) + arr.shape[1:], fill, arr.dtype)]
            )
        if arr.dtype == np.uint32:
            return sweeps.as_words(arr, self.device)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)


def _on(cache: dict, dev, *xs):
    """``xs`` on ``dev``, copied once per stream."""
    if dev not in cache:
        cache[dev] = tuple(x.to(dev) if isinstance(x, torch.Tensor) else x
                           for x in xs)
    return cache[dev]


def _groups(plan: MeshPlan):
    """Local shard positions grouped by device, in shard order."""
    out: Dict[torch.device, List[int]] = {}
    for i, d in enumerate(plan.local):
        out.setdefault(d, []).append(i)
    return out


# -------------------------------------------------------------------------
# fused step and restart-batched filter
# -------------------------------------------------------------------------


def lut5_fused_step(tables, combos, valid, target, mask, w_tab, m_tab, seed,
                    plan: Optional[MeshPlan] = None):
    """One fused 5-LUT step over a candidate chunk: feasibility filter, then
    the split / outer-function solve over the whole chunk, infeasible rows
    given all-conflicting constraints.  With ``plan`` each shard filters
    its block of the rows on its device (a spanning mesh gathers the
    blocks), and the solve runs on the gathered chunk, so the verdict is
    the unsharded one (priorities hash the row index, not the placement).
    Returns int32[3] (found, combo_index, split * 256 + outer_func)."""
    if plan is None:
        feas, r1, r0 = sweeps.lut_filter(tables, combos, valid, target, mask)
    else:
        n = combos.shape[0]
        s = plan.n_candidate_shards
        per = n // s
        cache: dict = {}
        parts = []
        for d, dev in plan.shards():
            tb, tg, mk = _on(cache, dev, tables, target, mask)
            lo = d * per
            with sweeps.device_ctx(dev):
                parts.append(sweeps.lut_filter(
                    tb, combos[lo:lo + per].to(dev),
                    valid[lo:lo + per].to(dev), tg, mk))
        feas, r1, r0 = (torch.cat([p[j].to(plan.device) for p in parts])
                        for j in range(3))
        if plan.spans_processes:
            feas, r1, r0 = (
                torch.from_numpy(dist.all_gather_array(x.cpu().numpy())
                                 .reshape((-1,) + tuple(x.shape[1:])))
                .to(plan.device)
                for x in (feas, r1, r0)
            )
    full = torch.full_like(r1, -1)
    r1 = torch.where(feas, r1, full)
    r0 = torch.where(feas, r0, full)
    return sweeps.lut5_solve(r1, r0, w_tab, m_tab, seed)


def restart_batched_filter():
    """The LUT feasibility filter over a leading restarts axis of targets
    (several outputs, permuted boxes or restarts at once): ``fn(tables,
    combos, valid, targets, mask)`` -> (feasible, req1, req0), each
    stacked over the targets."""

    def batched(tables, combos, valid, targets, mask):
        outs = [sweeps.lut_filter(tables, combos, valid, t, mask)
                for t in targets]
        return tuple(torch.stack([o[j] for o in outs]) for j in range(3))

    return batched


# -------------------------------------------------------------------------
# feasible stream
# -------------------------------------------------------------------------


class _ShardChunks:
    """Each local shard's block of a chunk: shard d takes ranks ``nxt + d *
    per + arange(per)``, the shards of one device in one call of the
    lanes' chunk constraints (K3's lane form for several 5-tuple lanes on a
    card)."""

    def __init__(self, plan, tables, binom, g, target, mask, excl, total, k,
                 per):
        self.plan, self.k, self.per = plan, k, per
        self.groups = []
        for dev, idxs in _groups(plan).items():
            L = len(idxs)
            rep = lambda x: x.to(dev)[None].expand(  # noqa: E731
                (L,) + tuple(x.shape)).contiguous()
            self.groups.append((dev, idxs, (
                rep(tables), binom.to(dev),
                torch.full((L,), int(g), dtype=torch.int64, device=dev),
                rep(target), rep(mask), rep(excl),
                torch.full((L,), int(total), dtype=torch.int64, device=dev),
            )))
        self.g = int(g)

    def sweep(self, nxt: int):
        """[(feasible, req1, req0)] of every local shard for the chunk at
        ``nxt``, in shard order."""
        out = [None] * len(self.plan.local)
        for dev, idxs, (tb, binom, gt, tg, mk, ex, tot) in self.groups:
            starts = torch.tensor(
                [nxt + (self.plan.first + i) * self.per for i in idxs],
                dtype=torch.int64, device=dev)
            ranks = starts[:, None] + torch.arange(
                self.per, dtype=torch.int64, device=dev)
            with sweeps.device_ctx(dev):
                feas, r1, r0 = sweeps._chunk_constraints_lanes(
                    tb, binom, gt, self.g, self.k, tg, mk, ex, ranks, tot,
                    len(idxs) > 1)
            for j, i in enumerate(idxs):
                out[i] = (feas[j], r1[j], r0[j])
        return out


def sharded_feasible_stream(plan: MeshPlan, tables, binom, g, target, mask,
                            excl, start, total, *, k: int, chunk: int,
                            compact: bool = False):
    """Mesh-sharded :func:`ops.sweeps.feasible_stream` over ranks [start,
    total), ``chunk`` a multiple of the shard count: each shard sweeps a
    contiguous ``chunk / n`` block of every chunk, and the stream stops at
    the first chunk holding a feasible tuple in any shard (one all-reduce
    per chunk across processes).

    On one process, and on a spanning mesh with ``compact=False`` (the
    overflow re-drive's full gather), returns (verdict int32[3] [found,
    chunk_start, examined], feasible [chunk], req1, req0) with the rows of
    ranks ``chunk_start + arange(chunk)`` on the plan's device.  On a
    spanning mesh with ``compact=True`` each shard ships at most
    :func:`gather_rows` rows (its first feasible ones) and the feasible
    counts ride the verdict: returns (verdict int32[3 + n], row_idx,
    feasible, req1, req0) numpy arrays of n x K rows, ``row_idx`` relative
    to the chunk (the JAX package's compact contract)."""
    n = plan.n_candidate_shards
    per = -(-chunk // n)
    start, total = int(start), int(total)
    sc = _ShardChunks(plan, tables, binom, g, target, mask, excl, total, k,
                      per)
    nxt, cstart, found, parts = start, start, False, None
    while nxt < total:
        parts = sc.sweep(nxt)
        hit = int(any(bool(f.any()) for f, _, _ in parts))
        if plan.spans_processes:
            hit = dist.all_reduce_max(hit)
        cstart, nxt = nxt, nxt + per * n
        if hit:
            found = True
            break
    examined = min(nxt, total) - start
    verdict = np.asarray([int(found), cstart, examined], np.int32)
    shape = (per,) if k <= 5 else (per, (1 << k) // 32)
    if parts is None:
        dev = plan.device
        parts = [(torch.zeros(per, dtype=torch.bool, device=dev),
                  torch.zeros(shape, dtype=torch.int32, device=dev),
                  torch.zeros(shape, dtype=torch.int32, device=dev))
                 ] * len(plan.local)
    if not plan.spans_processes:
        return (verdict, *(torch.cat([p[j].to(plan.device) for p in parts])
                           for j in range(3)))
    host = [tuple(x.cpu().numpy() for x in p) for p in parts]
    if compact:
        K = min(gather_rows(), per)
        counts = np.asarray([int(f.sum()) for f, _, _ in host], np.int32)
        rows, feas_c, r1_c, r0_c = [], [], [], []
        for i, (f, r1, r0) in enumerate(host):
            order = np.argsort(~f, kind="stable")[:K].astype(np.int32)
            rows.append((plan.first + i) * per + order)
            feas_c.append(f[order])
            r1_c.append(r1[order])
            r0_c.append(r0[order])
        all_counts = dist.all_gather_array(counts).reshape(-1)
        gath = [dist.all_gather_array(np.stack(x)).reshape(
            (n * K,) + np.stack(x).shape[2:])
            for x in (rows, feas_c, r1_c, r0_c)]
        return (np.concatenate([verdict, all_counts]).astype(np.int32), *gath)
    full = [dist.all_gather_array(np.stack([h[j] for h in host])).reshape(
        (n * per,) + host[0][j].shape[1:]) for j in range(3)]
    return (verdict, *(torch.from_numpy(x).to(plan.device) for x in full))


# -------------------------------------------------------------------------
# pivot stream
# -------------------------------------------------------------------------


def sharded_pivot_stream(
    plan: MeshPlan, tables, lc1, lc0, hc, lowvalid, highvalid, descs,
    start_t, t_end, w_tab, m_tab, seed, *, tl: int, th: int,
    backend: str = "packed",
):
    """Mesh-sharded :func:`ops.sweeps.lut5_pivot_stream` over pivot tiles
    [start_t, t_end): verdict rows int32[n, 10], row d (status, tile, m,
    lo_abs, hi_abs, sigma, func_outer, req1, req0, next_base) of shard d,
    the JAX package's lockstep contract: in round r shard d sweeps tile
    ``start_t + r * n + d``, the stream stops at the end of the first round
    holding a hit or a solver overflow in any shard, and each row is the
    shard's tile of that last round (its solve, zeros when it had no
    feasible candidate or lay past ``t_end``).  ``next_base`` is that
    round's end, ``start_t + (r + 1) * n``.  Each tile is solved with seed
    ``seed ^ t``, ``t`` its global index.

    Each shard sweeps its own tiles (``descs[start_t + d :: n]``, so its
    local tile z is round z) in windows of 1, 2, 4, ... rounds with the
    backend's window kernel (:data:`ops.sweeps.PIVOT_WINDOWS`: K1 for
    ``"packed"``, K2 for ``"pre"``), at most
    ``PIVOT_WINDOW_TILES / shards per device`` tiles a launch, on a card
    the next window launched before the host reads the last.  A window's feasible
    tiles are solved round by round (the heads of a device's shards in one
    sync) up to the first round with a hit; the group then takes the
    minimum of the ranks' first hit rounds, one all-reduce per window, and
    gathers the rows once at the end.  So the verdict equals that of
    one-tile rounds, whatever the windows."""
    n = plan.n_candidate_shards
    start_t, t_end = int(start_t), int(t_end)
    rounds = max(0, -(-(t_end - start_t) // n))
    descs = np.asarray(descs, np.int32).reshape(-1, 5)
    window = sweeps.PIVOT_WINDOWS[backend]
    seed32 = sweeps._wrap32(seed)
    cache: dict = {}
    shards = []
    for d, dev in plan.shards():
        own = np.ascontiguousarray(descs[start_t + d:t_end:n]) if (
            start_t + d < t_end) else np.zeros((0, 5), np.int32)
        ops = _on(cache, dev, tables, lc1, lc0, hc, lowvalid, highvalid,
                  w_tab, m_tab)
        shards.append({
            "d": d, "dev": dev, "ops": ops, "host": own, "T": own.shape[0],
            "descs": torch.from_numpy(own if own.shape[0] else
                                      np.zeros((1, 5), np.int32)).to(dev),
        })
    cap = max(1, sweeps.PIVOT_WINDOW_TILES // plan.shards_per_device)
    ncap = max(1, min(cap, rounds))
    for s in shards:
        s["bufs"] = ([pivot_tile.window_buffers(ncap, tl, th, s["dev"])
                      for _ in range(2)] if s["T"] else [])
    solved: Dict[tuple, tuple] = {}

    def launch(k, r0, w):
        parts = []
        for s in shards:
            nz = max(0, min(w, s["T"] - r0))
            if nz == 0:
                parts.append(None)
                continue
            with sweeps.device_ctx(s["dev"]):
                req1, req0, feas, counts = window(
                    *s["ops"][:6], s["descs"], r0, nz, s["T"], tl, th,
                    out=s["bufs"][k % 2], shard=s["d"],
                )
                read = sweeps._counts_reader(counts)
            parts.append((nz, req1, req0, feas, read))
        return r0, w, parts

    def consume(win) -> int:
        """Solves the window's feasible tiles round by round; returns this
        rank's first hit round (``_NO_HIT`` if none)."""
        r0, w, parts = win
        counts = [p[4]() if p is not None else [] for p in parts]
        for r in range(r0, r0 + w):
            heads = [i for i, p in enumerate(parts)
                     if p is not None and r - r0 < p[0] and counts[i][r - r0]]
            hit = False
            by_dev: Dict[torch.device, List[int]] = {}
            for i in heads:
                by_dev.setdefault(shards[i]["dev"], []).append(i)
            for dev, idxs in by_dev.items():
                z = r - r0
                ts = [start_t + r * n + shards[i]["d"] for i in idxs]
                pivot_tile.tiles["solved"] += len(idxs)
                w_t, m_t = shards[idxs[0]]["ops"][6:8]
                with sweeps.device_ctx(dev):
                    rows = sweeps._pivot_solve_lanes(
                        *(torch.stack([parts[i][j][z].reshape(-1)
                                       for i in idxs])
                          for j in (3, 1, 2)),
                        [seed32 ^ t for t in ts], w_t, m_t,
                        SHARDED_PIVOT_SOLVE_ROWS,
                    )
                for i, (fnd, nfeas, flat, sel, r1b, r0b) in zip(idxs, rows):
                    status = 1 if fnd else (
                        2 if nfeas > SHARDED_PIVOT_SOLVE_ROWS else 0)
                    dsc = shards[i]["host"][r]
                    solved[(i, r)] = (
                        status, int(dsc[0]), int(dsc[1]) + flat // th,
                        int(dsc[3]) + flat % th, sel // 256, sel % 256, r1b,
                        r0b,
                    )
                    hit = hit or status != 0
            if hit:
                return r
        return _NO_HIT

    def settle(win) -> int:
        h = consume(win)
        COLLECTIVES["windows"] += 1
        if plan.spans_processes:
            COLLECTIVES["window_reduces"] += 1
            h = dist.all_reduce_min(h)
        return h

    # On a card the next window launches before the host reads the last
    # (the card never waits for the host); the CPU's plain versions run as
    # they are called, so there a window is read at once.
    ahead = plan.device.type == "cuda"
    hit_round = _NO_HIT
    r, width, k, pending = 0, 1, 0, None
    while r < rounds:
        w = min(width, ncap, rounds - r)
        win = launch(k, r, w)
        k += 1
        r += w
        if not ahead:
            pending, win = win, None
        if pending is not None:
            hit_round = settle(pending)
            pending = None
            if hit_round != _NO_HIT:
                break
        pending = win
        width = min(2 * width, ncap)
    if pending is not None:
        hit_round = settle(pending)
    if rounds == 0:
        last, base = None, start_t
    elif hit_round != _NO_HIT:
        last, base = hit_round, start_t + (hit_round + 1) * n
    else:
        last, base = rounds - 1, start_t + rounds * n
    rows = np.zeros((len(shards), 10), np.int64)
    for i, s in enumerate(shards):
        if last is None:
            rows[i, 1] = -1
        else:
            rows[i, 1] = start_t + last * n + s["d"]
            rows[i, [0, 2, 3, 4, 5, 6, 7, 8]] = solved.get(
                (i, last), (0,) * 8)
        rows[i, 9] = base
    rows = rows.astype(np.int32)
    if plan.spans_processes:
        COLLECTIVES["gathers"] += 1
        rows = dist.all_gather_array(rows).reshape(n, 10)
    return rows
