"""Walsh-spectral candidate scoring for best-first sweep ordering.

PyTorch counterpart of the JAX package's ``ops/spectral.py`` (see that
module for the mathematics).  A gate's 256-bit truth table, packed in 8
words, expands to ±1 lanes (:func:`unpack_signs`; lane ``w*32 + j`` is bit
``j`` of word ``w``, a set bit is -1); the radix-2 Walsh–Hadamard butterfly
(:func:`wht`) runs in pure int32 adds; a gate's score is
``|dot(wht(gate), spectrum) // 256|`` against the WHT of the masked ±1
target (:func:`target_spectrum`) — by Parseval the masked
agree-minus-disagree count.  All arithmetic is integer, so scores are exact
and deterministic; they order the sweeps and never prune them.

The gate-score stage is the hand-written kernel K5
(``csrc/walsh_score.cu``), which replaces the TPU kernel
``sboxgates_tpu/ops/spectral.py:119`` (``_gate_scores_pallas``).  The
transform is symmetric, so K5 and its plain version transform the spectrum
once instead of every gate: ``dot(wht(x), s) == dot(x, wht(s))``, exactly
modulo 2^32, and with ``x`` the ±1 lanes of a gate that is the sum of
``wht(s)`` less twice its sum over the gate's set bits.  Words travel as
int32 bit patterns.  On a CUDA tensor :func:`gate_scores_kernel`
launches the kernel or raises; the plain version :func:`gate_scores_plain`
serves CPU tensors and the comparisons of the tests and ``chip_smoke.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _kernels
from ..telemetry import attribution as _tattr
from .lut5_filter import cells_t

#: Largest rank-space size the stream drivers score spectrally; beyond it
#: they keep lexicographic order (the JAX package's bound).
SPECTRAL_SCORE_MAX = 1 << 22

#: Kernel launches by :func:`gate_scores_kernel` (the plain version and the
#: CPU path do not count).
launches = 0

_I32 = torch.int32


def _unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """int32[..., W] words -> int32[..., W*32] 0/1 lanes: lane ``w*32 + j``
    is bit ``j`` of ``words[..., w]``."""
    w = words.shape[-1]
    sh = torch.arange(32, dtype=_I32, device=words.device)
    bits = (words[..., :, None] >> sh) & 1                  # [..., W, 32]
    return bits.reshape(words.shape[:-1] + (w * 32,))


def unpack_signs(words: torch.Tensor) -> torch.Tensor:
    """int32[..., W] words -> int32[..., W*32] ±1 lanes: lane ``w*32 + j``
    is ``1 - 2*bit(words[..., w], j)``."""
    return 1 - 2 * _unpack_bits(words)


def wht(x: torch.Tensor) -> torch.Tensor:
    """Walsh–Hadamard transform over the last axis (a power of two), in the
    JAX package's in-place order; exact int32 adds and subtracts."""
    n = x.shape[-1]
    assert n & (n - 1) == 0, n
    h = 1
    while h < n:
        y = x.reshape(x.shape[:-1] + (n // (2 * h), 2, h))
        a, b = y[..., 0, :], y[..., 1, :]
        x = torch.stack([a + b, a - b], dim=-2).reshape(x.shape)
        h *= 2
    return x


def target_spectrum(target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """WHT of the masked ±1 target: int32[256] from int32[8] words.  Lane
    p carries ``mask[p] * (1 - 2*target[p])``."""
    care = (unpack_signs(mask[None])[0] < 0).to(_I32)
    return wht(care * unpack_signs(target[None])[0])


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value of its low 32 bits (two's complement)."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(_I32)


def gate_scores_plain(tables: torch.Tensor, spectrum: torch.Tensor) -> torch.Tensor:
    """Plain version of K5, by its arithmetic: int32[B, 8] tables,
    int32[256] spectrum -> int32[B] ``|sum(wht(signs) * spectrum) // 256|``
    as ``S' = wht(spectrum)`` once and, per gate, ``sum(S') - 2 * sum(S'
    over the set bits)``.  The sum wraps modulo 2^32 as the JAX int32
    arithmetic does, and the division floors (the kernel must agree on any
    spectrum, not only real ones)."""
    sp = wht(spectrum.long())                                # exact in int64
    masked = torch.where(_unpack_bits(tables).bool(), sp, 0).sum(dim=-1)
    corr = _wrap32(sp.sum() - 2 * masked)
    return torch.abs(torch.div(corr, 256, rounding_mode="floor")).to(_I32)


def _check(tables, spectrum):
    for name, t in (("tables", tables), ("spectrum", spectrum)):
        if t.dtype != _I32:
            raise TypeError(f"gate_scores_kernel: {name} must be int32")
        if not t.is_contiguous():
            raise ValueError(f"gate_scores_kernel: {name} must be contiguous")
    if tables.device != spectrum.device:
        raise ValueError("gate_scores_kernel: operands on different devices")
    if tables.dim() != 2 or tables.shape[1] != 8:
        raise ValueError(f"tables must be [B, 8], got {tuple(tables.shape)}")
    if tuple(spectrum.shape) != (256,):
        raise ValueError(f"spectrum must be [256], got {tuple(spectrum.shape)}")
    if tables.is_cuda and tables.data_ptr() % 16:
        raise ValueError("gate_scores_kernel: tables must be 16-byte aligned")


def _sms(t: torch.Tensor) -> int:
    """SMs of ``t``'s card (K5's grid size); the H100's on the CPU."""
    if not t.is_cuda:
        return _tattr.H100_SMS
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def gate_scores_kernel(tables: torch.Tensor, spectrum: torch.Tensor) -> torch.Tensor:
    """K5: int32[B] scores of the gate tables ``tables`` int32[B, 8]
    against ``spectrum`` int32[256].  Bit-identical to the JAX package's
    ``_gate_scores_pallas`` and ``_gate_scores_xla``."""
    global launches
    _check(tables, spectrum)
    b = tables.shape[0]
    timed = _tattr.launch("walsh_score", f"{b}",
                          lambda: _tattr.walsh_cost(b, _sms(tables)), tables)
    if not tables.is_cuda:
        with timed:
            return gate_scores_plain(tables, spectrum)
    out = torch.empty(b, dtype=_I32, device=tables.device)
    fn, args = _kernels.lib().sbgt_walsh_scores, (
        tables.data_ptr(), b, spectrum.data_ptr(), out.data_ptr(),
        _kernels.stream_ptr(tables.device),
    )
    with timed as events:
        _kernels.check(fn(*args, *events), "gate_scores_kernel")
    launches += 1
    return out


def gate_scores(tables, target, mask) -> torch.Tensor:
    """Masked spectral correlation score per gate: int32[B] in [0, 256]
    (zero-padded bucket rows score garbage but are never gathered)."""
    return gate_scores_kernel(tables, target_spectrum(target, mask))


def cell_counts(tabs: torch.Tensor, target, mask) -> torch.Tensor:
    """Signed per-cell care counts for k-tuples: ``tabs`` int32[k, W, N]
    (candidate axis minormost), ``target``/``mask`` int32[W] -> int32[2^k,
    N], ``d[c] = #(mask & target in cell c) - #(mask & ~target in cell c)``
    with input 0 on the cell-index MSB."""
    cells = cells_t(tabs)                                    # [2^k, W, N]
    pos = _popcount(cells & (mask & target)[None, :, None])
    neg = _popcount(cells & (mask & ~target)[None, :, None])
    return (pos - neg).sum(dim=1, dtype=_I32)


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Per-word population count of int32 bit patterns (SWAR, int64)."""
    v = x.long() & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def span_scores(tabs: torch.Tensor, target, mask) -> torch.Tensor:
    """Exact span-correlation score per k-tuple: int32[N], the max
    |coefficient| of ``wht(cell_counts)`` over the non-empty subsets."""
    d = cell_counts(tabs, target, mask)                      # [2^k, N]
    coef = wht(torch.movedim(d, 0, -1))                      # [N, 2^k]
    return coef[..., 1:].abs().amax(dim=-1).to(_I32)


def quantize_tiers(scores, tiers: int = 4) -> np.ndarray:
    """Host-side linear score quantization into ``tiers`` equal-width
    integer bins between min and max (tier ``tiers-1`` = best); a flat
    score vector collapses to one tier."""
    s = np.asarray(scores, dtype=np.int64)
    lo, hi = int(s.min()), int(s.max())
    if hi == lo:
        return np.zeros(s.shape, dtype=np.int64)
    return (s - lo) * tiers // (hi - lo + 1)
