"""C / CUDA source emission (reference: print_c_function,
convert_graph.c:109-229).

Emits a self-contained bitslice function: plain C with ``unsigned long long``
lanes, or — when the circuit contains 3-input LUT gates — CUDA where each
LUT is an inline-PTX ``lop3.b32`` macro.  The text is the JAX package's
``codegen/c_emit.py`` output, character for character, including its one
deliberate deviation from the reference: outputs are counted over all 8
output slots, not only the first ``num_inputs`` (convert_graph.c:121,164).
"""

from __future__ import annotations

from typing import List

from ..core import boolfunc as bf
from ..graph.state import NO_GATE, State

_EXPR = {
    bf.FALSE_GATE: "{o} = 0;",
    bf.AND: "{o} = {a} & {b};",
    bf.A_AND_NOT_B: "{o} = {a} & ~{b};",
    bf.A: "{o} = {a};",
    bf.NOT_A_AND_B: "{o} = ~{a} & {b};",
    bf.B: "{o} = {b};",
    bf.XOR: "{o} = {a} ^ {b};",
    bf.OR: "{o} = {a} | {b};",
    bf.NOR: "{o} = ~({a} | {b});",
    bf.XNOR: "{o} = ({a} & {b}) | (~{a} & ~{b});",
    bf.NOT_B: "{o} = ~{b};",
    bf.A_OR_NOT_B: "{o} = {a} | ~{b};",
    bf.NOT_A: "{o} = ~{a};",
    bf.NOT_A_OR_B: "{o} = ~{a} | {b};",
    bf.NAND: "{o} = ~({a} & {b});",
    bf.TRUE_GATE: "{o} = ~0;",
    bf.NOT: "{o} = ~{a};",
}

TYPE = "bit_t"


def _var_name(st: State, gid: int, ptr_out: bool) -> str:
    """Inputs are struct fields, output gates the out parameters, every
    other gate a numbered temporary (reference: get_c_variable_name,
    convert_graph.c:93-107)."""
    if gid < st.num_inputs:
        return f"in.b{gid}"
    for bit in range(8):
        if st.outputs[bit] == gid:
            return ("*" if ptr_out else "") + f"out{bit}"
    return f"var{gid}"


def _needs_decl(st: State, gid: int) -> bool:
    return gid >= st.num_inputs and all(st.outputs[b] != gid for b in range(8))


def c_function_text(st: State) -> str:
    """The complete C (or CUDA) source text of the circuit.  Raises
    ValueError when the circuit has no outputs (the reference prints an
    error and returns false, convert_graph.c:127-130)."""
    cuda = any(g.type == bf.LUT for g in st.gates)
    out_bits = [b for b in range(8) if st.outputs[b] != NO_GATE]
    if not out_bits:
        raise ValueError("no output gates in circuit")
    ptr_ret = len(out_bits) > 1

    lines: List[str] = []
    if cuda:
        lines.append(
            '#define LUT(a,b,c,d,e) asm("lop3.b32 %0, %1, %2, %3, "#e";" : '
            '"=r"(a): "r"(b), "r"(c), "r"(d));'
        )
        lines.append(f"typedef int {TYPE};")
    else:
        lines.append(f"typedef unsigned long long int {TYPE};")
    lines.append("typedef struct {")
    for i in range(st.num_inputs):
        lines.append(f"  {TYPE} b{i};")
    lines.append("} bits;")

    qual = "__device__ __forceinline__ " if cuda else ""
    if ptr_ret:
        sig = f"{qual}void s(bits in"
        for b in out_bits:
            sig += f", {TYPE} *out{b}"
        sig += ") {"
    else:
        sig = f"{qual}{TYPE} s{out_bits[0]}(bits in) {{"
    lines.append(sig)

    for gid in range(st.num_inputs, st.num_gates):
        g = st.gates[gid]
        a = _var_name(st, g.in1, ptr_ret) if g.in1 != NO_GATE else ""
        b = _var_name(st, g.in2, ptr_ret) if g.in2 != NO_GATE else ""
        c = _var_name(st, g.in3, ptr_ret) if g.in3 != NO_GATE else ""
        o = _var_name(st, gid, ptr_ret)
        decl = _needs_decl(st, gid)
        start = f"  {TYPE} " if (decl or not o.startswith("*")) else "  "
        if g.type == bf.LUT:
            # No declaration for a dereferenced out-parameter (the
            # reference's shadows the parameter, convert_graph.c:217); a
            # single output's return variable does need one.
            decl_s = f"{TYPE} {o}; " if (decl or not o.startswith("*")) else ""
            lines.append(f"  {decl_s}LUT({o}, {a}, {b}, {c}, 0x%02x);" % g.function)
        else:
            lines.append(start + _EXPR[g.type].format(o=o, a=a, b=b))
        if not decl and not ptr_ret:
            lines.append(f"  return {o};")
    lines.append("}")
    return "\n".join(lines) + "\n"
