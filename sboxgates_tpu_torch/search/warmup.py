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
        # The chained rounds (search/rounds.py): a window of greedy rounds
        # in one call (merged windows run its lane form), and the stacked
        # form a wave of chains calls directly (it never merges).
        KernelDef("round_driver",
                  ("chunk3", "chunk5", "has5", "max_rounds", "solve_rows")),
        KernelDef("fleet_round_driver",
                  ("chunk3", "chunk5", "has5", "max_rounds", "solve_rows")),
    )
}

#: Operands a merged call shares across its lanes, per kernel (the JAX
#: package's table): the JAX package maps them ``in_axes=None`` where the
#: others gain the jobs axis.  The port's lane forms take every row's
#: operands and read the shared ones from the first row, so this table
#: documents which positions must agree across a merged group.
FLEET_SHARED: Dict[str, Tuple[int, ...]] = {
    "gate_step_stream": (2, 4, 8, 10, 11, 12),
    "lut_step_stream": (2, 4, 11, 12, 13),
    "lut7_step_stream": (1, 7, 8),
    "lut7_solve": (2, 3),
    "lut3_stream": (1, 5),
    "lut5_stream": (1, 8, 9),
    "feasible_stream": (1,),
    "lut5_solve": (2, 3),
    "lut5_pivot_stream": (9, 10),
    "lut5_pivot_tile": (),
    "pivot_pair_cells": (),
    # A round-chain window: binomial table, the empty exclusion array, the
    # 5-LUT space cap and the split tables; tables, g, targets, masks,
    # seeds, fill bytes and the round count are per lane.
    "round_driver": (1, 5, 9, 10, 11, 12),
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
