"""Graphviz DOT emission (reference: print_digraph, convert_graph.c:48-85).

One node per gate labelled with its type name (underscores as spaces),
``IN i`` for inputs and the hex function byte for LUTs; edges from each
gate's inputs, and ``outN`` sinks for the output map.  The text is the JAX
package's ``codegen/dot.py`` output, character for character.
"""

from __future__ import annotations

from ..core import boolfunc as bf
from ..graph.state import NO_GATE, State


def digraph_text(st: State) -> str:
    lines = ["digraph sbox {"]
    for gid, g in enumerate(st.gates):
        if g.type == bf.IN:
            name = f"IN {gid}"
        elif g.type == bf.LUT:
            name = "0x%02x" % g.function
        else:
            name = bf.GATE_NAMES[g.type].replace("_", " ")
        lines.append(f'  gt{gid} [label="{name}"];')
    for gid in range(st.num_inputs, st.num_gates):
        g = st.gates[gid]
        for src in (g.in1, g.in2, g.in3):
            if src != NO_GATE:
                lines.append(f"  gt{src} -> gt{gid};")
    for bit in range(8):
        if st.outputs[bit] != NO_GATE:
            lines.append(f"  gt{st.outputs[bit]} -> out{bit};")
    lines.append("}")
    return "\n".join(lines) + "\n"
