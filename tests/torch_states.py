"""Seeded states shared by the port's test files (torch only, no JAX, so
tests/test_torch_cuda.py can use it on a host without JAX)."""

import numpy as np

from sboxgates_tpu_torch.core import boolfunc as bf
from sboxgates_tpu_torch.graph.state import GATES, NO_GATE, State


def mixed_state(g: int = 200, seed: int = 5) -> State:
    """8-input state grown to ``g`` gates with seeded NOT gates, 2-input
    gates of every function and 3-LUTs; its last 8 gates are the outputs
    (the construction of chip_smoke.py's ``mixed_state``)."""
    rng = np.random.default_rng(seed)
    st = State.init_inputs(8)
    while st.num_gates < g:
        a, b, c = (int(x) for x in rng.choice(st.num_gates, size=3, replace=False))
        kind = int(rng.integers(3))
        if kind == 0:
            st.add_gate(bf.NOT, a, NO_GATE, GATES)
        elif kind == 1:
            st.add_gate(int(rng.integers(16)), a, b, GATES)
        else:
            st.add_lut(int(rng.integers(256)), a, b, c)
    st.outputs = list(range(g - 8, g))
    return st
