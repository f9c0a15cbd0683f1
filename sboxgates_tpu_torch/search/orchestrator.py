"""Search orchestration: the per-output iteration driver and the greedy
multi-output beam search (reference: generate_graph_one_output
sboxgates.c:661-688, generate_graph sboxgates.c:701-788).

With a :class:`~sboxgates_tpu_torch.resilience.journal.SearchJournal` both
drivers record each finished unit (an iteration, a beam round) and the run's
end, and a resumed run continues from the last one with the recorded budgets
and PRNG position: the JAX package's records, so its journals resume here.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional

import numpy as np

from ..core import ttable as tt
from ..graph.state import GATES, INT_MAX, MAX_GATES, NO_GATE, State
from ..graph.xmlio import save_state, state_filename
from ..resilience.faults import fault_point
from .context import SearchContext
from .kwan import create_circuit

BEAM_WIDTH = 20  # reference: out_states[20], sboxgates.c:704,713


class BeamFold:
    """Beam insertion with the metric ratchet (sboxgates.c:748-771): keeps
    up to BEAM_WIDTH states at the best metric seen, resetting the buffer
    whenever a strictly better state arrives."""

    def __init__(self, metric: int, log: Callable[[str], None] = print):
        self.metric = metric
        self.log = log
        self.max_gates = MAX_GATES
        self.max_sat_metric = INT_MAX
        self.states: List[State] = []

    def consider(self, nst: State, output: int) -> bool:
        """Folds one finished attempt; returns False when it found nothing."""
        if nst.outputs[output] == NO_GATE:
            self.log(f"No solution for output {output}.")
            return False
        if self.metric == GATES:
            if self.max_gates > nst.num_gates:
                self.max_gates = nst.num_gates
                self.states = []
            if nst.num_gates <= self.max_gates:
                if len(self.states) < BEAM_WIDTH:
                    self.states.append(nst)
                else:
                    self.log("Output state buffer full! Throwing away valid state.")
        else:
            if self.max_sat_metric > nst.sat_metric:
                self.max_sat_metric = nst.sat_metric
                self.states = []
            if nst.sat_metric <= self.max_sat_metric:
                if len(self.states) < BEAM_WIDTH:
                    self.states.append(nst)
                else:
                    self.log("Output state buffer full! Throwing away valid state.")
        return True


def make_targets(sbox: np.ndarray) -> List[np.ndarray]:
    return [tt.target_table(sbox, bit) for bit in range(8)]


def _store_publish_one(ctx, results, target, mask, output: int) -> None:
    """Publishes the best finished circuit of the one-output driver
    (results are best last) to the result store, keyed canonically, with
    the LUT sub-tables in LUT mode.  Asynchronous and best-effort: the
    store never touches the search's result."""
    store = getattr(ctx, "result_store", None)
    if store is None or not results:
        return
    store.put_state(
        results[-1], target, mask, ctx.opt.metric, output=output,
        sub_tables=ctx.opt.lut_graph, meta={"output_bit": output},
    )


def _store_publish_graph(ctx, states, targets, num_outputs, mask) -> None:
    """Publishes the all-outputs drivers' final state under its exact
    multi-output key, plus one canonical single-output entry per bound
    output (its cone) and the LUT sub-tables."""
    store = getattr(ctx, "result_store", None)
    if store is None or not states:
        return
    store.put_multi(
        states[0], [targets[o] for o in range(num_outputs)], mask,
        ctx.opt.metric, sub_tables=ctx.opt.lut_graph,
    )


def sbox_num_outputs(targets) -> int:
    for i in range(7, -1, -1):
        if (targets[i] != 0).any():
            return i + 1
    raise ValueError("S-box has no outputs")


def generate_graph_one_output(
    ctx: SearchContext,
    st: State,
    targets,
    output: int,
    save_dir: Optional[str] = ".",
    log: Callable[[str], None] = print,
    journal=None,
) -> List[State]:
    """``iterations`` independent attempts at one output bit, ratcheting the
    budget down after each success (sboxgates.c:661-688).  Returns all
    successful states, best last; each is saved to ``save_dir``.

    ``journal`` records each finished iteration (its checkpoint, the
    budgets, the PRNG position) and the run's end; resumed from it, the
    finished iterations come back from their checkpoints and the run goes
    on from the recorded position.  Requires ``save_dir``.

    With ``Options.batch_restarts`` (or a fleet) the restarts run as one
    concurrent batch instead (:func:`.batched.generate_graph_one_output_batched`:
    independent restarts, no budget ratchet between them)."""
    opt = ctx.opt
    log(f"Generating graphs for output {output}...")
    mask = tt.mask_table(st.num_inputs)
    if (opt.batch_restarts or opt.fleet) and opt.iterations > 1:
        from .batched import generate_graph_one_output_batched

        results = generate_graph_one_output_batched(
            ctx, st, targets, output, save_dir=save_dir, log=log,
            journal=journal,
        )
        _store_publish_one(ctx, results, targets[output], mask, output)
        return results
    results = []
    start_it = 0
    if journal is not None:
        rec = journal.last("iter_done")
        if rec is not None:
            start_it = rec["it"] + 1
            st.max_gates = rec["max_gates"]
            st.max_sat_metric = rec["max_sat_metric"]
            ctx.rng_restore(rec["rng"])
            results = [
                journal.load_checkpoint(r["ckpt"])
                for r in journal.of_type("iter_done")
                if r.get("ckpt")
            ]
            log(f"Resumed at iteration {start_it + 1}/{opt.iterations}.")
    for it in range(start_it, opt.iterations):
        nst = st.copy()
        nst.outputs[output] = create_circuit(ctx, nst, targets[output], mask, [])
        ckpt = None
        if nst.outputs[output] == NO_GATE:
            log(f"({it + 1}/{opt.iterations}): Not found.")
        else:
            log(
                f"({it + 1}/{opt.iterations}): "
                f"{nst.num_gates - nst.num_inputs} gates. "
                f"SAT metric: {nst.sat_metric}"
            )
            if save_dir is not None:
                ckpt = os.path.basename(save_state(nst, save_dir))
            results.append(nst)
            if opt.metric == GATES:
                st.max_gates = min(st.max_gates, nst.num_gates)
            else:
                st.max_sat_metric = min(st.max_sat_metric, nst.sat_metric)
        if journal is not None:
            journal.append(
                "iter_done", it=it, ckpt=ckpt,
                max_gates=st.max_gates, max_sat_metric=st.max_sat_metric,
                rng=ctx.rng_snapshot(),
            )
    if journal is not None:
        journal.append("run_done", beam=[state_filename(s) for s in results])
    _store_publish_one(ctx, results, targets[output], mask, output)
    return results


def generate_graph(
    ctx: SearchContext,
    st: State,
    targets,
    save_dir: Optional[str] = ".",
    log: Callable[[str], None] = print,
    journal=None,
) -> List[State]:
    """Greedy beam search over output order: repeatedly add every missing
    output to every surviving start state, keeping up to BEAM_WIDTH
    minimal-metric states per round (sboxgates.c:701-788).  Returns the
    final beam.

    ``journal`` records each finished round's beam (by checkpoint name, in
    beam order) and the PRNG position, and the run's end; resumed from it,
    the interrupted round reruns from its recorded position.  Requires
    ``save_dir``.

    With ``Options.batch_restarts`` (or a fleet) every (iteration x start x
    missing output) job of a round runs concurrently with the round-start
    budgets, and the results fold through the same beam in job order."""
    opt = ctx.opt
    num_outputs = sbox_num_outputs(targets)
    mask = tt.mask_table(st.num_inputs)
    if opt.chain_rounds > 0 and opt.iterations == 1 and opt.lut_graph:
        # --chain-rounds: the missing outputs as one greedy chain of rounds
        # over one growing graph (another driver than the beam search, so
        # opt-in; the same circuit for every chain_rounds above 0).
        return _generate_graph_chained(
            ctx, st, targets, num_outputs, mask, save_dir=save_dir,
            log=log, journal=journal,
        )
    start_states = [st]
    rnd = 0
    if journal is not None:
        rec = journal.last("round_done")
        if rec is not None:
            start_states = [journal.load_checkpoint(p) for p in rec["beam"]]
            ctx.rng_restore(rec["rng"])
            rnd = rec["round"]
            log(f"Resumed after round {rnd}.")
    while sum(1 for o in start_states[0].outputs if o != NO_GATE) < num_outputs:
        done = sum(1 for o in start_states[0].outputs if o != NO_GATE)
        beam = BeamFold(opt.metric, log)

        def consider(nst: State, output: int) -> None:
            # Every solution is saved, kept or not (sboxgates.c:746).
            if beam.consider(nst, output) and save_dir is not None:
                save_state(nst, save_dir)

        if opt.batch_restarts or opt.fleet:
            from .batched import run_batched_circuits

            jobs, meta = [], []
            for it in range(opt.iterations):
                for start in start_states:
                    for output in range(num_outputs):
                        if start.outputs[output] != NO_GATE:
                            continue
                        nst = start.copy()
                        if opt.metric == GATES:
                            nst.max_gates = beam.max_gates
                        else:
                            nst.max_sat_metric = beam.max_sat_metric
                        jobs.append((nst, targets[output], mask))
                        meta.append(output)
            log(
                f"Generating circuits with {done + 1} output"
                f"{'' if done == 0 else 's'}. ({len(jobs)} batched jobs)"
            )
            for output, (nst, out) in zip(meta, run_batched_circuits(ctx, jobs)):
                nst.outputs[output] = out
                consider(nst, output)
        else:
            for it in range(opt.iterations):
                log(
                    f"Generating circuits with {done + 1} output"
                    f"{'' if done == 0 else 's'}. ({it + 1}/{opt.iterations})"
                )
                for start in start_states:
                    for output in range(num_outputs):
                        if start.outputs[output] != NO_GATE:
                            log(f"Skipping output {output}.")
                            continue
                        log(f"Generating circuit for output {output}...")
                        nst = start.copy()
                        if opt.metric == GATES:
                            nst.max_gates = beam.max_gates
                        else:
                            nst.max_sat_metric = beam.max_sat_metric
                        nst.outputs[output] = create_circuit(
                            ctx, nst, targets[output], mask, []
                        )
                        consider(nst, output)
        if not beam.states:
            if journal is not None:
                journal.append("run_done", beam=[])
            return []
        if opt.metric == GATES:
            log(
                f"Found {len(beam.states)} state"
                f"{'' if len(beam.states) == 1 else 's'} with "
                f"{beam.max_gates - beam.states[0].num_inputs} gates."
            )
        else:
            log(
                f"Found {len(beam.states)} state"
                f"{'' if len(beam.states) == 1 else 's'} with SAT metric "
                f"{beam.max_sat_metric}."
            )
        start_states = beam.states
        rnd += 1
        _round_checkpoint(ctx, journal, rnd, beam.states, save_dir)
    if journal is not None:
        journal.append("run_done", beam=[state_filename(s) for s in start_states])
    _store_publish_graph(ctx, start_states, targets, num_outputs, mask)
    return start_states


def _generate_graph_chained(
    ctx, st, targets, num_outputs: int, mask,
    save_dir: Optional[str] = ".",
    log: Callable[[str], None] = print,
    journal=None,
) -> List[State]:
    """The ``Options.chain_rounds`` driver behind :func:`generate_graph`:
    every missing output, in output order, as one greedy chain of rounds
    (:func:`.rounds.run_round_chain`) over one growing graph; a round the
    round driver cannot finish runs the full recursive search for that
    output.  Returns the single final state."""
    from .rounds import run_round_chain

    missing = [o for o in range(num_outputs) if st.outputs[o] == NO_GATE]
    log(
        f"Chaining {len(missing)} output"
        f"{'' if len(missing) == 1 else 's'} "
        f"({ctx.opt.chain_rounds} rounds/dispatch)..."
    )
    rounds = [(targets[o], mask) for o in missing]
    outs = run_round_chain(
        ctx, st, rounds, rounds_per_dispatch=ctx.opt.chain_rounds,
        journal=journal,
    )
    for o, gid in zip(missing, outs):
        st.outputs[o] = gid
    log(f"Chained graph complete: {st.num_gates - st.num_inputs} gates.")
    if save_dir is not None:
        save_state(st, save_dir)
    if journal is not None:
        journal.append("run_done", beam=[state_filename(st)])
    _store_publish_graph(ctx, [st], targets, num_outputs, mask)
    return [st]


def _round_checkpoint(ctx, journal, rnd: int, beam_states, save_dir) -> None:
    """Round boundary: re-save the surviving beam (an atomic replace of
    files ``consider`` already wrote, which makes sure the files the record
    names are on disk), journal it, and mark the ``search.round`` fault
    site."""
    if journal is not None and journal.writable:
        for s in beam_states:
            save_state(s, save_dir)
        journal.append(
            "round_done", round=rnd,
            beam=[state_filename(s) for s in beam_states],
            rng=ctx.rng_snapshot(),
        )
        fault_point("search.round")
