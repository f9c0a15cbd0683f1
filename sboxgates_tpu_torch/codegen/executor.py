"""Circuit execution: the bitslice evaluator of a found circuit.

- :func:`compile_circuit` builds a plain PyTorch bitslice evaluator: the
  circuit unrolls into a chain of elementwise int32 operations, one per gate
  (each bit of a word is one evaluation, so a [W]-word batch evaluates 32 W
  S-box inputs at once).  It is the plain version of the circuit kernel K4
  (:mod:`.cuda_kernel`).
- :func:`eval_sbox` runs the circuit over all 2^n inputs on ``device`` and
  returns the S-box table it implements — on the card through K4.
- :func:`execute_native` runs the native runtime's bitslice interpreter
  (csrc ``sbg_execute_circuit``) on the host: a second, independent
  evaluator.

Words travel as int32 bit patterns, as everywhere in the port.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch

from ..core import boolfunc as bf
from ..core import ttable as tt
from ..graph.state import NO_GATE, State
from ..ops.sweeps import as_words, to_u32


def gate_arrays(st: State) -> Tuple[np.ndarray, ...]:
    """(types, in1, in2, in3, funcs) int32/uint8 arrays describing the
    circuit program (unused inputs are -1)."""
    types = np.array([g.type for g in st.gates], dtype=np.int32)

    def arr(f):
        return np.array(
            [f(g) if f(g) != NO_GATE else -1 for g in st.gates], dtype=np.int32
        )

    in1 = arr(lambda g: g.in1)
    in2 = arr(lambda g: g.in2)
    in3 = arr(lambda g: g.in3)
    funcs = np.array([g.function for g in st.gates], dtype=np.uint8)
    return types, in1, in2, in3, funcs


def output_bits(st: State) -> List[int]:
    return [b for b in range(8) if st.outputs[b] != NO_GATE]


def _gate2(f: int, a, b):
    """2-input gate of function nibble ``f`` (f(1,1) = bit 0, f(1,0) = bit
    1, f(0,1) = bit 2, f(0,0) = bit 3) as a sum of minterms."""
    terms = (a & b, a & ~b, ~a & b, ~a & ~b)
    r = a & ~a
    for k in range(4):
        if f >> k & 1:
            r = r | terms[k]
    return r


def _lut3(f: int, a, b, c):
    """3-LUT of function byte ``f``: bit k is the output for inputs
    ``k = A<<2 | B<<1 | C``."""
    r = a & ~a
    for k in range(8):
        if f >> k & 1:
            r = r | (
                (a if k & 4 else ~a) & (b if k & 2 else ~b) & (c if k & 1 else ~c)
            )
    return r


def compile_circuit(st: State) -> Callable:
    """Builds ``fn(inputs) -> outputs``, the plain bitslice evaluator.

    ``inputs``: int32 tensor ``[num_inputs, ...]`` — bit j of word
    ``inputs[i]`` is input variable i of evaluation j.  Returns
    ``[num_outputs, ...]`` in ``output_bits(st)`` order."""
    gates = [(g.type, g.in1, g.in2, g.in3, g.function) for g in st.gates]
    n_in = st.num_inputs
    outs = [st.outputs[b] for b in output_bits(st)]

    def fn(inputs):
        vals = [inputs[i] for i in range(n_in)]
        for gtype, i1, i2, i3, func in gates[n_in:]:
            if gtype == bf.NOT:
                vals.append(~vals[i1])
            elif gtype == bf.LUT:
                vals.append(_lut3(func, vals[i1], vals[i2], vals[i3]))
            else:
                vals.append(_gate2(gtype, vals[i1], vals[i2]))
        return torch.stack([vals[o] for o in outs])

    return fn


def eval_sbox(st: State, device="cuda") -> np.ndarray:
    """Evaluates the circuit over all 2^n inputs on ``device`` (on a card
    through the circuit kernel K4); returns the uint8 S-box table it
    implements, bits assembled from the circuit's output map."""
    from .cuda_kernel import compile_cuda  # imports this module

    n = st.num_inputs
    dev = torch.device(device)
    inputs = as_words(np.stack([tt.input_table(i) for i in range(n)]), dev)
    out = to_u32(compile_cuda(st, dev)(inputs))         # [n_out, 8]
    table = np.zeros(256, dtype=np.uint8)
    for row, b in enumerate(output_bits(st)):
        table |= tt.to_bits(out[row]).astype(np.uint8) << b
    return table[: 1 << n]


def execute_native(st: State) -> np.ndarray:
    """Runs the native interpreter; returns every gate's truth table as
    uint32[G, 8] (equal to ``st.live_tables()`` for a consistent state)."""
    from .. import native

    types, in1, in2, in3, funcs = gate_arrays(st)
    itab = native.tables32_to_64(st.tables[: st.num_inputs])
    out64 = native.execute_circuit(types, in1, in2, in3, funcs, itab)
    return np.ascontiguousarray(out64).view(np.uint32).reshape(-1, 8)
