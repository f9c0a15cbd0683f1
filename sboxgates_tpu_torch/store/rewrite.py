"""Circuit-graph rewriting under a :class:`~sboxgates_tpu_torch.core.canon.Transform`
(the JAX package's ``store/rewrite.py``, on the port's :class:`State`).

A stored circuit realizes its publisher's target in the publisher's
input frame.  A store hit in ANOTHER frame composes
``query -> canonical -> publisher`` into one transform ``r`` and rewires
the graph instead of re-searching:

* **input permutation** — publisher input ``i`` becomes query input
  ``r.perm^-1(i)`` (IN gates stay the contiguous prefix; internal gate
  ids are unchanged, so an identity transform reproduces the stored
  graph byte-for-byte),
* **input negation** — absorbed into the consuming gates' function
  values (the 16 2-input functions and the 256 3-LUT functions are both
  closed under input complement); a NOT gate fed a complemented value
  keeps its shape and hands the complement to ITS consumers instead,
* **output complement** — absorbed into the output gate's function when
  that gate has no other consumers, resolved through NOT gates by
  rebinding the output to their operand, and only as a last resort
  materialized as one appended NOT gate.

Truth tables and the SAT metric are recomputed by the ordinary
:meth:`State.replay_gate` mutators — never trusted from the store — and
the store's ``get`` re-verifies the rewritten output against the
ORIGINAL query table over all 2^8 inputs before anything is returned.
"""

from __future__ import annotations

from ..core import boolfunc as bf
from ..core.canon import Transform
from ..graph.state import NO_GATE, State


class RewriteError(Exception):
    """The stored graph cannot be rewritten into the query frame."""


def _gate2_negate_inputs(fun: int, na: int, nb: int) -> int:
    """The 2-input function value computing ``f(a ^ na, b ^ nb)``.

    The gate-type enum value IS the function's truth table
    (``f(1,1)=bit0, f(1,0)=bit1, f(0,1)=bit2, f(0,0)=bit3`` — see
    ``ttable.eval_gate2``), so negating an input permutes its bits.
    """
    if na:
        fun = ((fun >> 2) & 0b0011) | ((fun << 2) & 0b1100)
    if nb:
        fun = ((fun >> 1) & 0b0101) | ((fun << 1) & 0b1010)
    return fun


def _lut_negate_inputs(fun: int, na: int, nb: int, nc: int) -> int:
    """The 3-LUT function computing ``f(a ^ na, b ^ nb, c ^ nc)`` (bit
    ``k`` of ``fun`` is the output for ``k = A<<2 | B<<1 | C``)."""
    flip = (na << 2) | (nb << 1) | nc
    if not flip:
        return fun
    out = 0
    for k in range(8):
        if (fun >> (k ^ flip)) & 1:
            out |= 1 << k
    return out


def rewrite_state(st: State, t: Transform) -> State:
    """A new :class:`State` computing ``t . (each bound output's table)``
    over the transformed input frame; see the module docstring.  The
    identity transform reproduces the input graph exactly (same gates,
    same wiring, same outputs)."""
    n = st.num_inputs
    if t.n != n:
        raise RewriteError(
            f"transform is over {t.n} inputs, circuit has {n}"
        )
    inv = [0] * n
    for k, p in enumerate(t.perm):
        if not (0 <= p < n):
            raise RewriteError(f"bad transform permutation {t.perm}")
        inv[p] = k
    new = State.init_inputs(n)
    # old gate id -> (new gate id, pending output complement): a flag
    # means "the new gate holds the COMPLEMENT of what consumers want"
    # and is absorbed by each consumer in turn.
    gmap = {i: (inv[i], t.neg[inv[i]]) for i in range(n)}
    for gid in range(n, st.num_gates):
        g = st.gates[gid]
        if g.type == bf.IN:
            raise RewriteError("IN gate outside the input prefix")
        if g.type == bf.NOT:
            ni, f1 = gmap[g.in1]
            gmap[gid] = (new.replay_gate(bf.NOT, ni, NO_GATE), f1)
        elif g.type == bf.LUT:
            (a, fa), (b, fb), (c3, fc) = (
                gmap[g.in1], gmap[g.in2], gmap[g.in3]
            )
            fun = _lut_negate_inputs(g.function, fa, fb, fc)
            gmap[gid] = (
                new.replay_gate(bf.LUT, a, b, c3, function=fun), 0
            )
        else:
            (a, fa), (b, fb) = gmap[g.in1], gmap[g.in2]
            fun = _gate2_negate_inputs(g.type, fa, fb)
            gmap[gid] = (new.replay_gate(fun, a, b), 0)

    consumers = [0] * new.num_gates
    for g in new.gates:
        for ref in (g.in1, g.in2, g.in3):
            if ref != NO_GATE:
                consumers[ref] += 1
    # Output-binding multiplicity: a gate bound by MORE than one output
    # bit must never be complemented in place — the first bit's flip
    # would silently invert what the second bit observes.
    bound: dict = {}
    for bit in range(8):
        if st.outputs[bit] != NO_GATE:
            ni0 = gmap[st.outputs[bit]][0]
            bound[ni0] = bound.get(ni0, 0) + 1

    outputs = [NO_GATE] * 8
    for bit in range(8):
        if st.outputs[bit] == NO_GATE:
            continue
        ni, flag = gmap[st.outputs[bit]]
        own = ni  # this bit's own binding may count once in `bound`
        want = flag ^ t.comp
        while want:
            g = new.gates[ni]
            if g.type == bf.NOT:
                # ~(~x) == x: bind the output to the NOT's operand.
                ni, want = g.in1, want ^ 1
                continue
            others = bound.get(ni, 0) - (1 if ni == own else 0)
            if consumers[ni] == 0 and others == 0 and g.type != bf.IN:
                # Complement the function in place: the gate feeds only
                # this output, so nothing else observes the flip.
                if g.type == bf.LUT:
                    fun = ~g.function & 0xFF
                    if fun == 0:
                        break  # constant-true LUT: fall through to NOT
                    g.function = fun
                else:
                    g.type = ~g.type & 0xF
                new.tables[ni] = ~new.tables[ni]
                want = 0
                continue
            break
        if want:
            ni = new.replay_gate(bf.NOT, ni, NO_GATE)
            consumers.append(0)
            consumers[new.gates[ni].in1] += 1
        outputs[bit] = ni
    new.outputs = outputs
    return new
