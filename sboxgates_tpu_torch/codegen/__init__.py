"""Codegen and conversion (reference: convert_graph.c).

Emitters, text identical to the JAX package's:
- :func:`.dot.digraph_text` — Graphviz DOT;
- :func:`.c_emit.c_function_text` — a self-contained C bitslice function,
  or CUDA with inline-PTX ``lop3.b32`` LUT macros when the circuit holds
  LUT gates.

Executors:
- :func:`.executor.compile_circuit` — the plain PyTorch bitslice evaluator;
- :func:`.cuda_kernel.compile_cuda` — the circuit kernel K4 on the card;
- :func:`.executor.eval_sbox` — the S-box table a circuit implements;
- :func:`.executor.execute_native` — the native runtime's interpreter.
"""

from .c_emit import c_function_text
from .cuda_kernel import compile_cuda
from .dot import digraph_text
from .executor import (
    compile_circuit,
    eval_sbox,
    execute_native,
    gate_arrays,
    output_bits,
)

__all__ = [
    "c_function_text",
    "compile_circuit",
    "compile_cuda",
    "digraph_text",
    "eval_sbox",
    "execute_native",
    "gate_arrays",
    "output_bits",
]
