"""Seeded states and planted S-boxes shared by the port's test files
(torch only, no JAX, so tests/test_torch_cuda.py can use it on a host
without JAX).  They are the constructions of chip_smoke.py's functions of
the same names, which keeps its own copy; the committed inputs of the
resumes under tests/data/torch_golden/ were written from them."""

import os

import numpy as np

from sboxgates_tpu_torch.core import boolfunc as bf
from sboxgates_tpu_torch.core import ttable as tt
from sboxgates_tpu_torch.graph.state import GATES, NO_GATE, State
from sboxgates_tpu_torch.utils.sbox import load_sbox

RIJNDAEL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "sboxes", "rijndael.txt")


def random_state(g: int, seed: int) -> State:
    """8-input state from sboxes/rijndael.txt's inputs grown to ``g`` gates
    with seeded random 2-input gates."""
    rng = np.random.default_rng(seed)
    st = State.init_inputs(8)
    funs = (bf.AND, bf.OR, bf.XOR, bf.A_AND_NOT_B)
    while st.num_gates < g:
        a, b = rng.choice(st.num_gates, size=2, replace=False)
        st.add_gate(funs[int(rng.integers(len(funs)))], int(a), int(b), GATES)
    return st


def planted_sbox(st, gates=(90, 91, 92, 93, 94)):
    """sboxes/rijndael.txt with output bit 0 replaced by the planted 5-LUT
    0xB4(0x2D(a, b, c), d, e) over the gates ``gates`` of ``st``."""
    a, b, c, d, e = gates
    outer = tt.eval_lut(0x2D, st.table(a), st.table(b), st.table(c))
    target = tt.eval_lut(0xB4, outer, st.table(d), st.table(e))
    sbox, _ = load_sbox(RIJNDAEL)
    return (sbox & 0xFE) | tt.to_bits(target).astype(np.uint8)


def planted7_state(g: int = 22) -> State:
    """8-input state grown to ``g`` gates with seeded AND/OR/XOR/A_AND_NOT_B
    gates (the construction of the JAX package's tests/planted.py
    build_planted_lut7)."""
    rng = np.random.default_rng(3)
    st = State.init_inputs(8)
    funs = [bf.AND, bf.OR, bf.XOR, bf.A_AND_NOT_B]
    while st.num_gates < g:
        a, b = rng.choice(st.num_gates, size=2, replace=False)
        st.add_gate(funs[rng.integers(len(funs))], int(a), int(b), GATES)
    return st


def planted7_sbox(st):
    """sboxes/rijndael.txt with output bit 0 replaced by the planted 7-LUT
    0xCA(0x96(g9, g12, g17), 0xE8(g10, g15, g21), g19) of ``st``."""
    outer = tt.eval_lut(0x96, st.table(9), st.table(12), st.table(17))
    middle = tt.eval_lut(0xE8, st.table(10), st.table(15), st.table(21))
    target = tt.eval_lut(0xCA, outer, middle, st.table(19))
    sbox, _ = load_sbox(RIJNDAEL)
    return (sbox & 0xFE) | tt.to_bits(target).astype(np.uint8)


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
