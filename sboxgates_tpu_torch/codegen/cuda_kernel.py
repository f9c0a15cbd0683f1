"""Circuit kernel K4: a found circuit evaluated over bitsliced words on the
card.

Replaces the TPU kernel ``sboxgates_tpu/codegen/pallas_kernel.py:26``
(``compile_pallas``), which unrolled each circuit into its own Pallas
kernel.  ``csrc/circuit_eval.cu`` is one kernel for every circuit: an
interpreter over the gate program of :func:`.executor.gate_arrays`, packed
8 bytes per gate, with one thread per word column and the gate values in
shared memory (see the source's header for the design and its bound).

:func:`compile_cuda` returns ``fn(inputs)``: int32[n_in, W] ->
int32[n_out, W] in ``output_bits`` order.  On a CUDA tensor ``fn`` launches
the kernel or raises; a CPU tensor runs the plain version,
:func:`.executor.compile_circuit`.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .. import _kernels
from ..core import boolfunc as bf
from ..graph.state import State
from .executor import compile_circuit, gate_arrays, output_bits

#: Kernel launches by the functions :func:`compile_cuda` returns (the plain
#: version and the CPU path do not count).
launches = 0

#: Shared memory one block may use on the H100 (227 KB).  The only copy of
#: this limit: the kernel's launcher asks the card for what the block needs.
MAX_SMEM = 232448

#: Block sizes tried, largest first.
THREADS = (256, 128, 64, 32)


def block_shape(n_gates: int):
    """(threads, shared bytes) of a block for a program of ``n_gates``
    gates: the largest block whose program (8 B per gate) and gate values
    (4 B per gate and thread) fit in shared memory.  Raises ValueError for
    a program the kernel cannot take."""
    for t in THREADS:
        smem = 8 * n_gates + 4 * n_gates * t
        if smem <= MAX_SMEM:
            return t, smem
    raise ValueError(
        f"circuit of {n_gates} gates exceeds the circuit kernel's shared "
        f"memory ({MAX_SMEM} B at {THREADS[-1]} threads)"
    )


def pack_program(st: State) -> np.ndarray:
    """uint32[G, 2] program words: (in1 | in2 << 16, in3 | type << 16 |
    func << 24), unused inputs 0.  Raises ValueError on a gate the kernel
    does not evaluate or an input that is not an earlier gate."""
    types, in1, in2, in3, funcs = gate_arrays(st)
    n_in = st.num_inputs
    prog = np.zeros((len(types), 2), dtype=np.uint32)
    for g in range(n_in, len(types)):
        t = int(types[g])
        if t == bf.NOT:
            used = (in1[g],)
        elif t == bf.LUT:
            used = (in1[g], in2[g], in3[g])
        elif 0 <= t < 16:
            used = (in1[g], in2[g])
        else:
            raise ValueError(f"gate {g}: type {t} cannot be evaluated")
        if any(not 0 <= int(i) < g for i in used):
            raise ValueError(f"gate {g}: inputs {used} are not earlier gates")
        ids = [int(i) for i in used] + [0] * (3 - len(used))
        prog[g, 0] = ids[0] | (ids[1] << 16)
        prog[g, 1] = ids[2] | (t << 16) | (int(funcs[g]) << 24)
    return prog


def compile_cuda(st: State, device="cuda") -> Callable:
    """Builds ``fn(inputs) -> outputs`` backed by the circuit kernel.

    ``inputs``: contiguous int32[num_inputs, W] on ``device``; returns
    int32[num_outputs, W] in ``output_bits(st)`` order, bit-identical to
    the JAX package's ``compile_pallas`` and ``compile_circuit``."""
    dev = torch.device(device)
    plain = compile_circuit(st)
    n_in, n_gates = st.num_inputs, st.num_gates
    outs_np = np.array([st.outputs[b] for b in output_bits(st)], dtype=np.int32)
    n_out = len(outs_np)
    threads, smem = block_shape(n_gates)
    prog = torch.from_numpy(pack_program(st).view(np.int32)).to(dev)
    outs = torch.from_numpy(outs_np).to(dev)

    def fn(inputs: torch.Tensor) -> torch.Tensor:
        global launches
        if inputs.dtype != torch.int32:
            raise TypeError("circuit inputs must be int32 words")
        if inputs.dim() != 2 or inputs.shape[0] != n_in:
            raise ValueError(
                f"circuit inputs must be [{n_in}, W], got {tuple(inputs.shape)}"
            )
        if inputs.device != prog.device:
            raise ValueError(f"inputs on {inputs.device}, circuit on {prog.device}")
        if not inputs.is_cuda:
            return plain(inputs)
        if not inputs.is_contiguous():
            raise ValueError("circuit inputs must be contiguous")
        w = inputs.shape[1]
        out = torch.empty((n_out, w), dtype=torch.int32, device=inputs.device)
        err = _kernels.lib().sbgt_circuit_eval(
            prog.data_ptr(), n_gates, n_in, outs.data_ptr(), n_out,
            inputs.data_ptr(), w, out.data_ptr(), threads, smem,
            _kernels.stream_ptr(inputs.device),
        )
        _kernels.check(err, "circuit_eval")
        launches += 1
        return out

    return fn
