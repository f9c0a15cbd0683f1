"""The port's codegen against the JAX package's, on every examples/*.xml.

On the CPU: the plain bitslice evaluator (the circuit kernel K4's plain
version) and ``compile_cuda(device="cpu")`` against the JAX package's
``compile_circuit`` and ``compile_pallas`` in interpret mode, word for word
on random words with a ragged width; ``eval_sbox`` against the JAX
package's; the C and DOT text character for character; and the CLI's
``-c``/``-d`` output.  K4 itself is held against the plain version on a
card in tests/test_torch_cuda.py and chip_smoke.py.
"""

import glob
import os
import sys

import numpy as np
import pytest
import torch

from sboxgates_tpu.codegen import c_function_text as j_c_text
from sboxgates_tpu.codegen import compile_circuit as j_compile
from sboxgates_tpu.codegen import digraph_text as j_dot_text
from sboxgates_tpu.codegen import eval_sbox as j_eval_sbox
from sboxgates_tpu.codegen.pallas_kernel import compile_pallas
from sboxgates_tpu.graph.xmlio import load_state as j_load_state

from sboxgates_tpu_torch import cli
from sboxgates_tpu_torch.codegen import (
    c_function_text,
    compile_circuit,
    compile_cuda,
    digraph_text,
    eval_sbox,
)
from sboxgates_tpu_torch.codegen import cuda_kernel
from sboxgates_tpu_torch.core import boolfunc as bf
from sboxgates_tpu_torch.graph.state import GATES, State
from sboxgates_tpu_torch.graph.xmlio import load_state
from sboxgates_tpu_torch.utils.sbox import load_sbox

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_states import mixed_state  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_golden")
EXAMPLES = sorted(glob.glob(os.path.join(ROOT, "examples", "*.xml")))
IDS = [os.path.basename(p)[:-4] for p in EXAMPLES]


def _sbox_of(path):
    """The S-box file an example was searched for (examples/des_s1_bit0_*
    -> sboxes/des_s1.txt)."""
    name = os.path.basename(path)
    box = "_".join(name.split("_")[:2])
    return os.path.join(ROOT, "sboxes", box + ".txt")


@pytest.mark.parametrize("path", EXAMPLES, ids=IDS)
def test_evaluators_match_jax(path):
    """Plain evaluator and compile_cuda on the CPU equal the JAX package's
    compile_circuit and compile_pallas (interpret mode), word for word."""
    jst, st = j_load_state(path), load_state(path)
    rng = np.random.default_rng(len(path))
    x = rng.integers(0, 2**32, size=(st.num_inputs, 300), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(j_compile(jst)(x))
    np.testing.assert_array_equal(
        np.asarray(compile_pallas(jst, block=256, interpret=True)(x)), want
    )
    xt = torch.from_numpy(x.view(np.int32).copy())
    np.testing.assert_array_equal(compile_circuit(st)(xt).numpy().view(np.uint32), want)
    before = cuda_kernel.launches
    got = compile_cuda(st, device="cpu")(xt)
    assert cuda_kernel.launches == before  # a CPU tensor runs the plain version
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("path", EXAMPLES, ids=IDS)
def test_eval_sbox_matches_jax_and_the_sbox(path):
    jst, st = j_load_state(path), load_state(path)
    got = eval_sbox(st, device="cpu")
    np.testing.assert_array_equal(got, j_eval_sbox(jst))
    sbox, n = load_sbox(_sbox_of(path))
    bits = sum(1 << b for b in range(8) if st.outputs[b] != 0xFFFF)
    np.testing.assert_array_equal(got & bits, sbox[: 1 << n] & bits)


@pytest.mark.parametrize("path", EXAMPLES, ids=IDS)
def test_emitted_text_matches_jax(path):
    jst, st = j_load_state(path), load_state(path)
    assert c_function_text(st) == j_c_text(jst)
    assert digraph_text(st) == j_dot_text(jst)


@pytest.mark.parametrize("flag", ["-c", "-d"])
@pytest.mark.parametrize("path", EXAMPLES, ids=IDS)
def test_cli_conversion_prints_the_jax_clis_text(flag, path, capsys):
    from sboxgates_tpu.cli import main as jax_main

    capsys.readouterr()
    assert jax_main([flag, path]) == 0
    want = capsys.readouterr()
    assert cli.main([flag, path]) == 0
    got = capsys.readouterr()
    assert got.out == want.out and got.out
    assert got.err == want.err == ""


GOLDEN_TEXT = {
    ("-c", "des_s1_bit0_lut_best"): "des_s1_bit0_lut_best.cu",
    ("-d", "des_s1_bit0_lut_best"): "des_s1_bit0_lut_best.dot",
    ("-c", "des_s1_bit0_17gates"): "des_s1_bit0_17gates.c",
    ("-d", "des_s1_bit0_17gates"): "des_s1_bit0_17gates.dot",
}


@pytest.mark.parametrize("flag,name", sorted(GOLDEN_TEXT))
def test_conversion_golden_text_is_the_jax_clis(flag, name, capsys):
    """The committed text chip_smoke.py holds the card's -c/-d runs to is
    what the JAX CLI prints."""
    from sboxgates_tpu.cli import main as jax_main

    capsys.readouterr()
    assert jax_main([flag, os.path.join(ROOT, "examples", name + ".xml")]) == 0
    with open(os.path.join(GOLDEN, GOLDEN_TEXT[flag, name])) as f:
        assert capsys.readouterr().out == f.read()


def test_conversion_errors_match_the_jax_cli(capsys, tmp_path):
    """-c on a circuit without outputs, a missing file, a corrupt file,
    more than one file, and -c with -d: the JAX CLI's one-line errors."""
    from sboxgates_tpu.cli import main as jax_main
    from sboxgates_tpu_torch.graph.xmlio import state_to_xml

    no_out = State.init_inputs(3)
    no_out.add_gate(bf.AND, 0, 1, GATES)
    bare = tmp_path / "no_outputs.xml"
    bare.write_text(state_to_xml(no_out))
    bad = tmp_path / "corrupt.xml"
    bad.write_text("<gates>")
    cases = [
        ["-c", str(bare)],
        ["-c", str(tmp_path / "missing.xml")],
        ["-d", str(bad)],
        ["-c", str(bare), str(bare)],
        ["-c", "-d", str(bare)],
    ]
    for argv in cases:
        capsys.readouterr()
        assert jax_main(argv) == 1
        want = capsys.readouterr().err.strip()
        assert cli.main(argv) == 1
        got = capsys.readouterr().err.strip()
        assert got == want and got.count("\n") == 0, argv


def test_circuit_kernel_rejects_what_it_cannot_take():
    """The wrapper raises on a program that does not fit the kernel's
    shared memory and on wrong operands; it never falls back."""
    assert cuda_kernel.block_shape(7, 5) == (128, 7 * 16 + 5 * 16 * 128)
    # 33 slots: three blocks of 128 threads per SM, as many threads as six
    # of 64 or twelve of 32
    assert cuda_kernel.block_shape(74, 33) == (128, 74 * 16 + 33 * 16 * 128)
    assert cuda_kernel.block_shape(500, 400) == (32, 500 * 16 + 400 * 16 * 32)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_kernel.block_shape(500, 500)
    st = load_state(EXAMPLES[0])
    fn = compile_cuda(st, device="cpu")
    with pytest.raises(TypeError):
        fn(torch.zeros((st.num_inputs, 4), dtype=torch.int64))
    with pytest.raises(ValueError):
        fn(torch.zeros((st.num_inputs + 1, 4), dtype=torch.int32))


def test_pack_program_layout():
    """One instruction per live gate over reused slots: the XOR frees input
    2's slot and takes it, the NOT takes it back, the LUT (the output)
    reads slots 1, 2, 0 and takes slot 0; the dead AND is dropped."""
    st = State.init_inputs(3)
    a = st.add_gate(bf.XOR, 0, 2, GATES)
    st.add_gate(bf.AND, 0, 1, GATES)
    n = st.add_not_gate(a, GATES)
    lut = st.add_lut(0xCA, 1, n, 0)
    st.outputs[0] = lut
    prog, out_slots, n_slots = cuda_kernel.pack_program(st)
    assert prog.dtype == np.uint32 and prog.shape == (3, 4)
    assert tuple(prog[0]) == (0x3C | 1 << 8 | 2 << 16, 0, 2, 0)
    assert tuple(prog[1]) == (0x0F | 2 << 16, 2, 2, 2)
    assert tuple(prog[2]) == (0xCA | 3 << 8 | 0 << 16, 1, 2, 0)
    assert out_slots.tolist() == [0] and n_slots == 3


def _lop3_plain(imm, a, b, c):
    """lop3.b32 in torch: bit k of ``imm`` is the output where (a, b, c) =
    (k >> 2, k >> 1, k) & 1."""
    r = torch.zeros_like(a)
    for k in range(8):
        if imm >> k & 1:
            r = r | ((a if k & 4 else ~a) & (b if k & 2 else ~b) & (c if k & 1 else ~c))
    return r


def _run_program(prog, out_slots, n_slots, x):
    """The lowered program run as the kernel runs it, on torch words."""
    vals = [None] * n_slots
    for i in range(x.shape[0]):
        vals[i] = x[i]
    for ctrl, a, b, c in prog.tolist():
        vals[ctrl >> 16] = _lop3_plain(ctrl & 0xFF, vals[a], vals[b], vals[c])
    return torch.stack([vals[s] for s in out_slots.tolist()])


@pytest.mark.parametrize("path", EXAMPLES + ["mixed"], ids=IDS + ["mixed_g200"])
def test_lop3_program_matches_compile_circuit(path):
    """K4's lowering on the CPU: the (imm8, a, b, c, dst) program over the
    liveness slot plan, run by a plain LOP3, equals the plain evaluator
    (ragged width, words with bit 31 set); ignored operands name a's slot,
    and the plan needs no more slots than gates."""
    st = mixed_state() if path == "mixed" else load_state(path)
    prog, out_slots, n_slots = cuda_kernel.pack_program(st)
    rng = np.random.default_rng(st.num_gates)
    x = torch.from_numpy(rng.integers(-2**31, 2**31, size=(st.num_inputs, 37))
                         .astype(np.int32))
    assert torch.equal(_run_program(prog, out_slots, n_slots, x), compile_circuit(st)(x))
    ctrl = prog[:, 0]
    assert ((ctrl >> 8 & 1 == 1) | (prog[:, 2] == prog[:, 1])).all()
    assert ((ctrl >> 9 & 1 == 1) | (prog[:, 3] == prog[:, 1])).all()
    assert len(prog) <= st.num_gates - st.num_inputs and n_slots <= st.num_gates


def test_select_tree_covers_the_immediates_that_ignore_c():
    """The kernel's branch-free path for an immediate that ignores c (NOT,
    2-input gates): the multiplexer trees over the immediate's bit masks
    (csrc/circuit_eval.cu: eval_gate), mirrored here on bytes, give the
    LOP3 of every such immediate."""
    a, b = np.uint32(0xF0), np.uint32(0xCC)
    sel = lambda s, x1, x0: (s & x1) | (~s & x0)  # noqa: E731
    two_input = [imm for imm in range(256) if not ((imm >> 1) ^ imm) & 0x55]
    assert len(two_input) == 16
    for imm in two_input:
        m = [np.uint32(0xFFFFFFFF * (imm >> k & 1)) for k in range(8)]
        use_b = ((imm >> 2) ^ imm) & 0x33 != 0
        if use_b:
            got = sel(a, sel(b, m[6], m[4]), sel(b, m[2], m[0]))
        else:
            got = sel(a, m[4], m[0])
        assert int(got) & 0xFF == imm, hex(imm)
    kinds = {cuda_kernel.lop3_imm(f, 0) for f in range(16)} | {cuda_kernel.lop3_imm(bf.NOT, 0)}
    assert kinds <= set(two_input)


@pytest.mark.parametrize("kind", ["gate2", "not", "lut"])
def test_lop3_imm_matches_gate_semantics(kind):
    """Every gate's immediate, applied to the three input patterns, is the
    gate's truth table (the port's ttable.eval_gate2 / eval_lut)."""
    from sboxgates_tpu_torch.core import ttable as tt

    a, b, c = (np.uint32(x) for x in (0xF0, 0xCC, 0xAA))
    if kind == "gate2":
        for f in range(16):
            want = int(tt.eval_gate2(f, a, b)) & 0xFF
            assert cuda_kernel.lop3_imm(f, 0) == want, f
    elif kind == "not":
        assert cuda_kernel.lop3_imm(bf.NOT, 0) == int(~a) & 0xFF
    else:
        for f in range(256):
            assert cuda_kernel.lop3_imm(bf.LUT, f) == int(tt.eval_lut(f, a, b, c)) & 0xFF
    with pytest.raises(ValueError):
        cuda_kernel.lop3_imm(17, 0)
