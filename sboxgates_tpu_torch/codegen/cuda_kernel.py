"""Circuit kernel K4: a found circuit evaluated over bitsliced words on the
card.

Replaces the TPU kernel ``sboxgates_tpu/codegen/pallas_kernel.py:26``
(``compile_pallas``), which unrolled each circuit into its own Pallas
kernel.  ``csrc/circuit_eval.cu`` is one kernel for every circuit: it runs
the program :func:`pack_program` lowers from the circuit, one
``lop3.b32`` per live gate and word, over value slots that a liveness pass
reuses (see the source's header for the design and its bound).

:func:`compile_cuda` returns ``fn(inputs)``: int32[n_in, W] ->
int32[n_out, W] in ``output_bits`` order.  On a CUDA tensor ``fn`` launches
the kernel or raises; a CPU tensor runs the plain version,
:func:`.executor.compile_circuit`.
"""

from __future__ import annotations

import heapq
from typing import Callable, Tuple

import numpy as np
import torch

from .. import _kernels
from ..core import boolfunc as bf
from ..graph.state import State
from ..telemetry import attribution as _tattr
from .executor import compile_circuit, gate_arrays, output_bits

#: Kernel launches by the functions :func:`compile_cuda` returns (the plain
#: version and the CPU path do not count).
launches = 0

#: Shared memory one block may use on the H100 (227 KB).  The only copy of
#: this limit: the kernel's launcher asks the card for what the block needs.
MAX_SMEM = 232448

#: Shared memory of one SM (228 KB), of which the card keeps 1 KB per
#: resident block.
SM_SMEM = 233472

#: Block sizes tried (the kernel's launch bounds take 128 at most); each
#: thread evaluates 4 word columns.
THREADS = (128, 64, 32)


def block_shape(n_prog: int, n_slots: int) -> Tuple[int, int]:
    """(threads, shared bytes) of a block for a program of ``n_prog``
    instructions over ``n_slots`` value slots: 16 B per instruction and 16
    B per slot and thread (4 words).  Of the block sizes that fit, the one
    that keeps the most threads resident on an SM, the larger on a tie.
    Raises ValueError for a program the kernel cannot take."""
    best = None
    for t in THREADS:
        smem = 16 * n_prog + 16 * n_slots * t
        if smem > MAX_SMEM:
            continue
        # at most 64 registers a thread (the launch bounds): 1024 threads
        resident = min(32, 1024 // t, SM_SMEM // (smem + 1024)) * t
        if best is None or resident > best[0]:
            best = (resident, t, smem)
    if best is None:
        raise ValueError(
            f"circuit program of {n_prog} instructions over {n_slots} live "
            f"values exceeds the circuit kernel's shared memory ({MAX_SMEM} B "
            f"at {THREADS[-1]} threads)"
        )
    return best[1], best[2]


def lop3_imm(gate_type: int, func: int) -> int:
    """The ``lop3.b32`` immediate of a gate over (a, b, c) = (in1, in2,
    in3), bit k the output for k = a<<2 | b<<1 | c: a 3-LUT's function
    byte; for a 2-input gate of type f (f(1,1) = bit 0, f(1,0) = bit 1,
    f(0,1) = bit 2, f(0,0) = bit 3) the immediate that ignores c; 0x0F for
    NOT."""
    if gate_type == bf.NOT:
        return 0x0F
    if gate_type == bf.LUT:
        return int(func) & 0xFF
    if not 0 <= gate_type < 16:
        raise ValueError(f"gate type {gate_type} cannot be evaluated")
    imm = 0
    for k in range(8):
        x, y = k >> 2 & 1, k >> 1 & 1
        imm |= (gate_type >> ((1 - x) * 2 + (1 - y)) & 1) << k
    return imm


def pack_program(st: State) -> Tuple[np.ndarray, np.ndarray, int]:
    """Lowers the circuit for the kernel: (prog uint32[n, 4], out_slots
    int32[n_out], n_slots).

    One instruction per gate an output needs, in depth-first post-order
    from the outputs (operands first, in input order), as
    ``(imm | use_b << 8 | use_c << 9 | dst << 16, a, b, c)`` over value
    slots: ``vals[dst] = lop3(vals[a], vals[b], vals[c], imm)``, where
    ``use_b``/``use_c`` say whether the immediate reads b/c (an operand it
    ignores names a's slot).  Inputs start in slots 0..n_in-1; a slot is
    free again after its value's last reader, and the smallest free slot
    takes each new value; outputs stay live to the end, read from
    ``out_slots`` in ``output_bits`` order.  Raises ValueError on a gate the
    kernel does not evaluate or an input that is not an earlier gate."""
    types, in1, in2, in3, funcs = gate_arrays(st)
    n_in, n_gates = st.num_inputs, len(types)
    outs = [int(st.outputs[b]) for b in output_bits(st)]
    operands = {}
    for g in range(n_in, n_gates):
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
        operands[g] = tuple(int(i) for i in used)
    # Depth-first post-order from the outputs: only the gates an output
    # needs, each after its operands, close to their readers.
    order, seen = [], set()
    for root in outs:
        stack = [(root, 0)]
        while stack:
            g, i = stack.pop()
            if g < n_in or (i == 0 and g in seen):
                continue
            seen.add(g)
            if i < len(operands[g]):
                stack += [(g, i + 1), (operands[g][i], 0)]
            else:
                order.append(g)
    last = {}
    for i, g in enumerate(order):
        for v in operands[g]:
            last[v] = i
    for v in outs:
        last[v] = len(order)
    slot = {i: i for i in range(n_in)}
    free = [i for i in range(n_in) if i not in last]
    heapq.heapify(free)
    n_slots = n_in
    prog = np.zeros((len(order), 4), dtype=np.uint32)
    for i, g in enumerate(order):
        ops = operands[g]
        a, b, c = (ops + (ops[0],) * 2)[:3]
        src = (slot[a], slot[b], slot[c])
        for v in set(ops):
            if last[v] == i:
                heapq.heappush(free, slot.pop(v))
        if free:
            dst = heapq.heappop(free)
        else:
            dst, n_slots = n_slots, n_slots + 1
        slot[g] = dst
        imm = lop3_imm(int(types[g]), int(funcs[g]))
        use_b = ((imm >> 2) ^ imm) & 0x33 != 0
        use_c = ((imm >> 1) ^ imm) & 0x55 != 0
        prog[i] = (imm | use_b << 8 | use_c << 9 | dst << 16, src[0],
                   src[1] if use_b else src[0], src[2] if use_c else src[0])
    out_slots = np.array([slot[v] for v in outs], dtype=np.int32)
    return prog, out_slots, n_slots


def compile_cuda(st: State, device="cuda") -> Callable:
    """Builds ``fn(inputs) -> outputs`` backed by the circuit kernel.

    ``inputs``: contiguous int32[num_inputs, W] on ``device``; returns
    int32[num_outputs, W] in ``output_bits(st)`` order, bit-identical to
    the JAX package's ``compile_pallas`` and ``compile_circuit``."""
    dev = torch.device(device)
    plain = compile_circuit(st)
    n_in = st.num_inputs
    prog_np, outs_np, n_slots = pack_program(st)
    n_prog, n_out = len(prog_np), len(outs_np)
    threads, smem = block_shape(n_prog, n_slots)
    prog = torch.from_numpy(prog_np.view(np.int32)).to(dev)
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
        w = inputs.shape[1]
        timed = _tattr.launch(
            "circuit_eval", f"{n_in}x{n_out}x{n_prog}x{w}",
            lambda: _tattr.circuit_cost(n_in, n_out, n_prog, w), inputs)
        if not inputs.is_cuda:
            with timed:
                return plain(inputs)
        if not inputs.is_contiguous():
            raise ValueError("circuit inputs must be contiguous")
        out = torch.empty((n_out, w), dtype=torch.int32, device=inputs.device)
        fn, args = _kernels.lib().sbgt_circuit_eval, (
            prog.data_ptr(), n_prog, n_in, outs.data_ptr(), n_out,
            inputs.data_ptr(), w, out.data_ptr(), threads, smem,
            _kernels.stream_ptr(inputs.device),
        )
        with timed as events:
            _kernels.check(fn(*args, *events), "circuit_eval")
        launches += 1
        return out

    return fn
