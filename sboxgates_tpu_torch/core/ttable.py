"""Truth-table bitvector primitives (host side, numpy).

A truth table (*ttable*) represents a Boolean function of up to eight
variables as a 256-bit vector: bit ``i`` holds the function value for input
``i``.  It is stored as **eight little-endian uint32 words** (last axis):
bit ``i`` lives in word ``i // 32`` at position ``i % 32``.  A batch of N
tables is a ``uint32[N, 8]`` array.

These helpers are the host oracle: the search state keeps its tables in
numpy, and the device sweeps receive them as int32 bit patterns
(:mod:`sboxgates_tpu_torch.ops.sweeps`).
"""

from __future__ import annotations

import numpy as np

N_WORDS = 8
WORD_BITS = 32
TABLE_BITS = N_WORDS * WORD_BITS  # 256

_FULL_WORD = np.uint32(0xFFFFFFFF)


def zero() -> np.ndarray:
    """All-false truth table."""
    return np.zeros(N_WORDS, dtype=np.uint32)


def ones() -> np.ndarray:
    """All-true truth table."""
    return np.full(N_WORDS, _FULL_WORD, dtype=np.uint32)


def from_bits(bits) -> np.ndarray:
    """Packs a boolean array (last axis = 256) into uint32 words (last axis = 8)."""
    # torchlint: ignore[R2x] host-side helper by contract (numpy only): callers pass host bit arrays; a device value crossing here is the documented boundary
    bits = np.asarray(bits, dtype=bool)
    assert bits.shape[-1] == TABLE_BITS
    b = bits.reshape(bits.shape[:-1] + (N_WORDS, WORD_BITS)).astype(np.uint32)
    shifts = np.arange(WORD_BITS, dtype=np.uint32)
    return (b << shifts).sum(axis=-1, dtype=np.uint32)


def to_bits(tt) -> np.ndarray:
    """Unpacks uint32 words (last axis = 8) into a boolean array (last axis = 256)."""
    tt = np.asarray(tt, dtype=np.uint32)
    assert tt.shape[-1] == N_WORDS
    shifts = np.arange(WORD_BITS, dtype=np.uint32)
    bits = (tt[..., :, None] >> shifts) & np.uint32(1)
    return bits.reshape(tt.shape[:-1] + (TABLE_BITS,)).astype(bool)


def target_table(sbox: np.ndarray, bit: int) -> np.ndarray:
    """Truth table of output bit ``bit`` of an S-box: bit ``i`` of the result
    is ``(sbox[i] >> bit) & 1`` (reference: generate_target, state.c:232-250)."""
    sbox = np.asarray(sbox, dtype=np.uint32)
    assert sbox.shape == (256,)
    return from_bits((sbox >> np.uint32(bit)) & np.uint32(1))


def input_table(var: int) -> np.ndarray:
    """Truth table of input variable ``var``: bit ``i`` is ``(i >> var) & 1``."""
    assert 0 <= var < 8
    idx = np.arange(TABLE_BITS, dtype=np.uint32)
    return from_bits((idx >> np.uint32(var)) & np.uint32(1))


def mask_table(num_inputs: int) -> np.ndarray:
    """Mask with the low ``2**num_inputs`` bits set (reference: generate_mask,
    sboxgates.c:644-659)."""
    assert 1 <= num_inputs <= 8
    valid = 1 << num_inputs
    idx = np.arange(TABLE_BITS, dtype=np.uint32)
    return from_bits(idx < valid)


def is_zero(tt):
    """True where the table (last axis) is all-zero."""
    return ~(tt != 0).any(axis=-1)


def eq_mask(a, b, mask):
    """Masked equality: true where ``a`` and ``b`` agree on all bits set in
    ``mask`` (reference: ``ttable_equals_mask``, sboxgates.c:91-93)."""
    return is_zero((a ^ b) & mask)


def _fresh(x):
    """Pass-through result, copied so callers never alias a live gate table."""
    return np.copy(x) if isinstance(x, np.ndarray) else x


# Direct expressions per gate nibble (enum value = truth table with
# f(1,1)=bit0, f(1,0)=bit1, f(0,1)=bit2, f(0,0)=bit3).
_GATE2_DIRECT = {
    0b0000: lambda a, b: a & ~a,
    0b0001: lambda a, b: a & b,
    0b0010: lambda a, b: a & ~b,
    0b0011: lambda a, b: _fresh(a),
    0b0100: lambda a, b: ~a & b,
    0b0101: lambda a, b: _fresh(b),
    0b0110: lambda a, b: a ^ b,
    0b0111: lambda a, b: a | b,
    0b1000: lambda a, b: ~(a | b),
    0b1001: lambda a, b: ~(a ^ b),
    0b1010: lambda a, b: ~b,
    0b1011: lambda a, b: a | ~b,
    0b1100: lambda a, b: ~a,
    0b1101: lambda a, b: ~a | b,
    0b1110: lambda a, b: ~(a & b),
    0b1111: lambda a, b: ~(a & ~a),
}


def eval_gate2(fun, a, b):
    """Evaluates a 2-input gate given its 4-bit function value (reference:
    get_val, boolfunc.c:22-25).  ``fun`` may be a scalar or an integer array
    broadcastable against ``a``/``b``."""
    f = fun
    if isinstance(f, (int, np.integer)):
        return _GATE2_DIRECT[int(f) & 0xF](a, b)
    b0 = -((f >> 0) & 1)  # all-ones where bit set (two's complement trick)
    b1 = -((f >> 1) & 1)
    b2 = -((f >> 2) & 1)
    b3 = -((f >> 3) & 1)
    b0, b1, b2, b3 = (x.astype(a.dtype) for x in (b0, b1, b2, b3))
    return (b0 & a & b) | (b1 & a & ~b) | (b2 & ~a & b) | (b3 & ~a & ~b)


def eval_lut(func, a, b, c):
    """Evaluates a 3-input LUT given its 8-bit function value: bit ``k`` of
    ``func`` is the output for inputs ``k = A<<2 | B<<1 | C`` (reference:
    generate_lut_ttable, state.c:202-230)."""
    f = func
    scalar = isinstance(f, (int, np.integer))

    def bit(k):
        v = -((f >> k) & 1)
        if scalar:
            return np.uint32(v & 0xFFFFFFFF)
        return v.astype(a.dtype)

    return (
        (bit(0) & ~a & ~b & ~c)
        | (bit(1) & ~a & ~b & c)
        | (bit(2) & ~a & b & ~c)
        | (bit(3) & ~a & b & c)
        | (bit(4) & a & ~b & ~c)
        | (bit(5) & a & ~b & c)
        | (bit(6) & a & b & ~c)
        | (bit(7) & a & b & c)
    )


def table_as_hex(tt) -> str:
    """Debug representation: 64 hex chars, most significant position first."""
    words = np.asarray(tt, dtype=np.uint32)
    return "".join(f"{int(w):08x}" for w in words[::-1])


def ttable_text(tt) -> str:
    """The reference's debug ttable dump (print_ttable, convert_graph.c:28-45):
    256 bits as 16 rows of 16 '0'/'1' characters, position 0 first."""
    words = np.asarray(tt, dtype=np.uint32).reshape(8)
    bits = ((words[:, None] >> np.arange(32)[None, :]) & 1).reshape(256)
    rows = [
        "".join(str(int(b)) for b in bits[r : r + 16])
        for r in range(0, 256, 16)
    ]
    return "\n".join(rows) + "\n"
