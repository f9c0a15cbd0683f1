"""Several S-boxes and permutation sweeps as one batch of jobs.

PyTorch counterpart of the JAX package's ``search/multibox.py``.  The
reference searches one S-box per process, with one ``--permute`` value;
here every (box | permutation) x iteration attempt is an independent
``create_circuit`` job, run serially (``--serial-jobs``, and the default of
a permutation sweep), as a rendezvous batch (:mod:`.batched`, the default
for several boxes) or as a fleet (:mod:`.fleet`).  All modes fold the
results through the same per-box logic in job order, so the kept states
are the same given the same per-job outcomes; the batched and fleet modes
draw one seed per job in a block (parallel-restart semantics: no budget
ratchet across a box's attempts).

States land in a subdirectory per box (``<output-dir>/<box>/``, ``pXX/``
for a permutation), as the JAX CLI writes them.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..core import ttable as tt
from ..graph.state import GATES, NO_GATE, State
from ..graph.xmlio import save_state, state_filename
from ..resilience.faults import fault_point
from ..utils.sbox import permuted_box
from .context import SearchContext
from .kwan import create_circuit
from .orchestrator import BeamFold, make_targets, sbox_num_outputs


@dataclass
class BoxJob:
    """One S-box (or one permutation of one) in a sweep.  ``prefer_serial``
    marks job families whose default is the serial loop (permutation
    sweeps)."""

    name: str
    sbox: np.ndarray  # uint8[256]
    num_inputs: int
    targets: List = field(default_factory=list)
    n_out: int = 0
    beam: Optional[BeamFold] = None
    done: bool = False
    prefer_serial: bool = False

    def __post_init__(self):
        if not self.targets:
            self.targets = make_targets(self.sbox)
        self.n_out = sbox_num_outputs(self.targets)
        self.mask = tt.mask_table(self.num_inputs)


#: Jobs per rendezvous wave of the batched mode (one thread each; the
#: JAX package's largest vmap bucket).
MAX_WAVE_JOBS = 32


def _run_jobs(
    ctx: SearchContext,
    jobs: List[Tuple[State, np.ndarray, np.ndarray]],
    batched,
) -> List[Tuple[State, int]]:
    if batched == "fleet" and len(jobs) > 1:
        from .fleet import run_fleet_waves

        return run_fleet_waves(ctx, jobs)
    if batched and batched != "fleet" and len(jobs) > 1:
        from .batched import run_batched_circuits

        out = []
        for lo in range(0, len(jobs), MAX_WAVE_JOBS):
            out.extend(run_batched_circuits(ctx, jobs[lo : lo + MAX_WAVE_JOBS]))
        return out
    out = []
    for i, (nst, target, mask) in enumerate(jobs):
        t0 = time.perf_counter()
        res = create_circuit(ctx, nst, target, mask, [])
        ctx.observe_job(f"serial-{i}", t0, time.perf_counter(), res != NO_GATE)
        out.append((nst, res))
    return out


def _auto_batched(ctx: SearchContext, batched, boxes: Sequence[BoxJob] = ()):
    """The execution mode: ``"fleet"`` for a fleet context or when asked;
    otherwise ``batched=None`` is serial when a job family prefers it
    (:attr:`BoxJob.prefer_serial`) and batched elsewhere."""
    if batched == "fleet" or (batched is None and ctx.opt.fleet):
        return "fleet"
    if batched is None:
        return not any(b.prefer_serial for b in boxes)
    return batched


def _mode_name(batched) -> str:
    if batched == "fleet":
        return "fleet"
    return "batched" if batched else "serial"


def _save_dir_for(save_dir: Optional[str], name: str) -> Optional[str]:
    """The box's subdirectory (the reference's file names do not name the
    box)."""
    if save_dir is None:
        return None
    d = os.path.join(save_dir, name)
    os.makedirs(d, exist_ok=True)
    return d


def _job_journals(ctx, boxes, output, save_dir, journal) -> Optional[dict]:
    """Per-box journals of the one-output driver beside the box's states,
    fresh or resumed as the run journal is."""
    if journal is None:
        return None
    from ..resilience.journal import SearchJournal

    root = save_dir if save_dir is not None else journal.directory
    return {
        box.name: SearchJournal.for_job(
            root, box.name,
            {"job": box.name, "output": output,
             "iterations": ctx.opt.iterations},
            resume=journal.resumed, readonly=journal.readonly,
        )
        for box in boxes
    }


def search_boxes_one_output(
    ctx: SearchContext,
    boxes: Sequence[BoxJob],
    output: int,
    save_dir: Optional[str] = ".",
    log: Callable[[str], None] = print,
    batched=None,
    journal=None,
) -> dict:
    """One output bit of every box, ``iterations`` independent attempts per
    box.  Returns {box.name: [successful states, best last]}.

    With ``journal`` every box gets its own journal: the serial mode
    records a ``job_done`` (checkpoint and PRNG position) per attempt, so a
    killed sweep resumes with the finished attempts replayed; the batched
    and fleet modes record one ``jobs_done`` per box after the wave (a kill
    inside the wave reruns it from the recorded PRNG state)."""
    batched = _auto_batched(ctx, batched, boxes)
    r = ctx.opt.iterations
    for box in boxes:
        if output >= box.n_out:
            raise ValueError(
                f"{box.name}: can't generate output bit {output}; "
                f"box only has {box.n_out} outputs"
            )
    jj = _job_journals(ctx, boxes, output, save_dir, journal)
    log(
        f"Searching output {output} of {len(boxes)} S-boxes, "
        f"{r} iteration{'s' if r != 1 else ''} each "
        f"({len(boxes) * r} {_mode_name(batched)} jobs)..."
    )
    results: dict = {box.name: [] for box in boxes}

    def fold(box, nst, out) -> Optional[str]:
        """Logs and saves one finished attempt; returns its checkpoint name
        (relative to the box directory) or None."""
        if out == NO_GATE:
            log(f"{box.name}: not found.")
            return None
        nst.outputs[output] = out
        log(
            f"{box.name}: {nst.num_gates - nst.num_inputs} gates. "
            f"SAT metric: {nst.sat_metric}"
        )
        results[box.name].append(nst)
        d = _save_dir_for(save_dir, box.name)
        if d is None:
            return None
        return os.path.basename(save_state(nst, d))

    if jj is not None and not batched:
        for box in boxes:
            jr = jj[box.name]
            done_recs = {rec["it"]: rec for rec in jr.of_type("job_done")}
            for it in range(r):
                rec = done_recs.get(it)
                if rec is not None:
                    ctx.rng_restore(rec["rng"])
                    if rec.get("ckpt"):
                        results[box.name].append(jr.load_checkpoint(rec["ckpt"]))
                    log(f"{box.name}: iteration {it + 1}/{r} resumed "
                        "from the journal.")
                    continue
                nst = State.init_inputs(box.num_inputs)
                out = create_circuit(ctx, nst, box.targets[output], box.mask, [])
                ckpt = fold(box, nst, out)
                jr.append("job_done", it=it, ckpt=ckpt, rng=ctx.rng_snapshot())
                fault_point("search.round")
    elif jj is not None and all(
        jj[box.name].last("jobs_done") is not None for box in boxes
    ):
        for box in boxes:
            rec = jj[box.name].last("jobs_done")
            ctx.rng_restore(rec["rng"])
            results[box.name] = [
                jj[box.name].load_checkpoint(p) for p in rec["files"]
            ]
            log(f"{box.name}: resumed from the journal.")
    else:
        # A fresh (or mid-wave-killed) batched or fleet sweep: the wave
        # reruns from the run's recorded PRNG state, deterministically, so
        # boxes that got their jobs_done record before a kill reproduce the
        # same checkpoints and keep their records.
        jobs, meta = [], []
        for box in boxes:
            for _ in range(r):
                jobs.append((State.init_inputs(box.num_inputs),
                             box.targets[output], box.mask))
                meta.append(box)
        files: dict = {box.name: [] for box in boxes}
        for box, (nst, out) in zip(meta, _run_jobs(ctx, jobs, batched)):
            ckpt = fold(box, nst, out)
            if ckpt is not None:
                files[box.name].append(ckpt)
        if jj is not None:
            for box in boxes:
                if jj[box.name].last("jobs_done") is None:
                    jj[box.name].append("jobs_done", files=files[box.name],
                                        rng=ctx.rng_snapshot())
    for states in results.values():
        if ctx.opt.metric == GATES:
            states.sort(key=lambda s: -s.num_gates)
        else:
            states.sort(key=lambda s: -s.sat_metric)
    if journal is not None and journal.writable and not journal.complete:
        journal.append(
            "run_done",
            boxes={name: len(states) for name, states in results.items()},
        )
    return results


def search_boxes_all_outputs(
    ctx: SearchContext,
    boxes: Sequence[BoxJob],
    save_dir: Optional[str] = ".",
    log: Callable[[str], None] = print,
    batched=None,
    journal=None,
) -> dict:
    """The full-graph beam search of every box, in lockstep rounds: each
    round gathers every (box x start state x missing output x iteration)
    attempt into one batch of jobs, then folds the results through each
    box's own beam (the single-box driver's beam semantics,
    sboxgates.c:701-788).  Finished boxes drop out.  Returns {box.name:
    final beam states}.  ``journal`` records every box's beam and the PRNG
    position at each round boundary (``mb_round_done``); a resumed sweep
    reruns the interrupted round."""
    batched = _auto_batched(ctx, batched, boxes)
    opt = ctx.opt
    beams = {box.name: [State.init_inputs(box.num_inputs)] for box in boxes}
    final: dict = {box.name: [] for box in boxes}
    live = list(boxes)
    rnd = 0
    if journal is not None:
        rec = journal.last("mb_round_done")
        if rec is not None:
            rnd = rec["round"]
            ctx.rng_restore(rec["rng"])
            live = []
            for box in boxes:
                ent = rec["boxes"].get(box.name)
                if ent is None:
                    continue
                states = [journal.load_checkpoint(p) for p in ent["beam"]]
                beams[box.name] = states
                if ent["done"]:
                    final[box.name] = states
                elif states:
                    live.append(box)
            log(f"Resumed after round {rnd}.")
    while live:
        rnd += 1
        jobs, meta = [], []
        for box in live:
            box.beam = BeamFold(opt.metric, log)
            for _ in range(opt.iterations):
                for start in beams[box.name]:
                    for output in range(box.n_out):
                        if start.outputs[output] != NO_GATE:
                            continue
                        nst = start.copy()
                        # Round-start budgets: the round's attempts are
                        # independent.
                        if opt.metric == GATES:
                            nst.max_gates = box.beam.max_gates
                        else:
                            nst.max_sat_metric = box.beam.max_sat_metric
                        jobs.append((nst, box.targets[output], box.mask))
                        meta.append((box, output))
        log(
            f"Round {rnd}: {len(jobs)} "
            f"{_mode_name(batched)} jobs over "
            f"{len(live)} box{'es' if len(live) != 1 else ''}..."
        )
        for (box, output), (nst, out) in zip(meta, _run_jobs(ctx, jobs, batched)):
            nst.outputs[output] = out
            # Every solution is saved, kept or not (sboxgates.c:746).
            if box.beam.consider(nst, output):
                d = _save_dir_for(save_dir, box.name)
                if d is not None:
                    save_state(nst, d)
        still = []
        for box in live:
            if not box.beam.states:
                log(f"{box.name}: no solution this round; giving up.")
                beams[box.name] = []
                continue
            beams[box.name] = box.beam.states
            n_done = sum(1 for o in box.beam.states[0].outputs if o != NO_GATE)
            if n_done >= box.n_out:
                final[box.name] = box.beam.states
                log(
                    f"{box.name}: complete, "
                    f"{box.beam.states[0].num_gates - box.beam.states[0].num_inputs}"
                    f" gates."
                )
            else:
                still.append(box)
        live = still
        if journal is not None and journal.writable:
            boxes_state = {}
            for box in boxes:
                states, done = (
                    (final[box.name], True) if final[box.name]
                    else (beams[box.name], False)
                )
                # Only live beams are re-saved (the files the record names
                # exist); a finished box's beam was saved the round it
                # completed.
                d = None if done else _save_dir_for(save_dir, box.name)
                names = []
                for s in states:
                    if d is not None:
                        save_state(s, d)
                    names.append(f"{box.name}/{state_filename(s)}")
                boxes_state[box.name] = {"beam": names, "done": done}
            journal.append("mb_round_done", round=rnd, boxes=boxes_state,
                           rng=ctx.rng_snapshot())
            fault_point("search.round")
    if journal is not None:
        journal.append(
            "run_done",
            boxes={
                name: [f"{name}/{state_filename(s)}" for s in states]
                for name, states in final.items()
            },
        )
    return final


def load_box_jobs(paths: Sequence[str], permute: int = 0) -> List[BoxJob]:
    """BoxJobs from S-box files, named by file stem; same-named files from
    different directories get a ``~N`` suffix (every driver keys its beams,
    results and directories by name)."""
    from ..utils.sbox import load_sbox

    jobs = []
    seen: dict = {}
    for p in paths:
        sbox, n = load_sbox(p, permute)
        stem = os.path.splitext(os.path.basename(p))[0]
        seen[stem] = seen.get(stem, 0) + 1
        name = stem if seen[stem] == 1 else f"{stem}~{seen[stem]}"
        jobs.append(BoxJob(name, sbox, n))
    return jobs


def permute_sweep_jobs(sbox: np.ndarray, num_inputs: int) -> List[BoxJob]:
    """One BoxJob per input permutation (all 2^n), named ``pXX`` (hex): the
    driver-level form of running the reference once per ``--permute``
    value.  Serial by default (``prefer_serial``), as in the JAX package."""
    return [
        BoxJob(f"p{p:02x}", permuted_box(sbox, num_inputs, p), num_inputs,
               prefer_serial=True)
        for p in range(1 << num_inputs)
    ]
