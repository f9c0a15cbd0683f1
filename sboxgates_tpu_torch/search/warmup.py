"""The sweep kernel registry: one table from kernel names to the port's
single-lane and lane-batched callables.

The JAX package's ``search/warmup.py`` keeps this table for two users: the
live dispatchers (``SearchContext.kernel_call`` / ``_dispatch`` /
``stream_dispatch``, the rendezvous of ``search/batched.py`` and
``search/fleet.py``) and its background AOT warmer.  The port has no
compile step to warm (the CUDA kernels are built once by
:mod:`sboxgates_tpu_torch._kernels`, and PyTorch runs eagerly), so only the
registry half is ported: ``KERNELS``, :func:`kernel` and :func:`warm_key`.
``--no-warmup`` and ``--compile-cache`` are accepted by the CLI and change
nothing.

Each entry names a sweep of :mod:`sboxgates_tpu_torch.ops.sweeps` that the
search layer dispatches through the registry, and its lane form there
(``<name>_lanes(rows, **statics) -> [verdict per row]``), which a rendezvous
runs for a merged group.  The wide and spectral streams are not in it: the
JAX package dispatches them from their own thread too (``kernel_call``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Dict, Sequence, Tuple

from ..ops import sweeps


@dataclass(frozen=True)
class KernelDef:
    """One registry entry: the sweep and its lane form ``<name>_lanes``
    (resolved from :mod:`..ops.sweeps` at call time, so tests that
    monkeypatch the module keep working) and its static argument names."""

    name: str
    static_names: Tuple[str, ...]

    @property
    def fn(self) -> Callable:
        return getattr(sweeps, self.name)

    @property
    def lanes(self) -> Callable:
        return getattr(sweeps, f"{self.name}_lanes")


#: Name -> definition of every sweep the search layer dispatches.
KERNELS: Dict[str, KernelDef] = {
    d.name: d
    for d in (
        KernelDef("gate_step_stream", ("chunk3", "has_not", "has_triple")),
        KernelDef("lut_step_stream", ("chunk3", "chunk5", "has5", "solve_rows")),
        KernelDef("lut7_step_stream", ("chunk7", "solve7")),
        KernelDef("lut3_stream", ("chunk",)),
        KernelDef("lut5_stream", ("chunk", "solve_rows")),
        KernelDef("feasible_stream", ("k", "chunk")),
        KernelDef("lut5_pivot_stream", ("tl", "th", "solve_rows", "backend")),
        KernelDef("lut5_pivot_tile", ("tl", "th", "backend")),
        KernelDef("pivot_pair_cells", ()),
        KernelDef("lut5_solve", ()),
        KernelDef("lut7_solve", ()),
    )
}


def kernel(name: str, statics: dict) -> Callable:
    """The single-lane callable of a registry entry with its statics bound.
    Validates the static names, so a drifted call site fails loudly."""
    d = KERNELS[name]
    unknown = set(statics) - set(d.static_names)
    if unknown:
        raise TypeError(
            f"kernel {name!r} does not take static args {sorted(unknown)}; "
            f"registry declares {d.static_names}"
        )
    return functools.partial(d.fn, **statics) if statics else d.fn


def arg_signature(args: Sequence) -> tuple:
    """Hashable shape/dtype signature of positional operands: tensors and
    arrays sign as (shape, dtype), Python scalars by type."""
    out = []
    for a in args:
        shape = getattr(a, "shape", None)
        dtype = getattr(a, "dtype", None)
        if shape is not None and dtype is not None:
            out.append((tuple(shape), str(dtype)))
        else:
            out.append((type(a).__name__,))
    return tuple(out)


def warm_key(name: str, statics: dict, args: Sequence) -> tuple:
    """The merge key of a rendezvous submission: kernel, statics and
    operand shapes — only same-shaped sweeps stack into one lane form."""
    return (name, tuple(sorted(statics.items())), arg_signature(args))
