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
    assert cuda_kernel.block_shape(7) == (256, 7 * 8 + 7 * 4 * 256)
    assert cuda_kernel.block_shape(500) == (64, 500 * 8 + 500 * 4 * 64)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_kernel.block_shape(2000)
    st = load_state(EXAMPLES[0])
    fn = compile_cuda(st, device="cpu")
    with pytest.raises(TypeError):
        fn(torch.zeros((st.num_inputs, 4), dtype=torch.int64))
    with pytest.raises(ValueError):
        fn(torch.zeros((st.num_inputs + 1, 4), dtype=torch.int32))


def test_pack_program_layout():
    st = State.init_inputs(3)
    a = st.add_gate(bf.XOR, 0, 2, GATES)
    n = st.add_not_gate(a, GATES)
    lut = st.add_lut(0xCA, 1, n, 0)
    prog = cuda_kernel.pack_program(st)
    assert prog.dtype == np.uint32 and prog.shape == (6, 2)
    assert (prog[:3] == 0).all()
    assert tuple(prog[a]) == (0 | 2 << 16, 0 | bf.XOR << 16)
    assert tuple(prog[n]) == (a, bf.NOT << 16)
    assert tuple(prog[lut]) == (1 | n << 16, 0 | bf.LUT << 16 | 0xCA << 24)
