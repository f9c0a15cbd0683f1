"""Circuit graph state.

The search state is a DAG of gates, each carrying its full 256-bit truth
table.  Mirrors the reference's ``gate``/``state`` structs
(``state.h:72-88``) with the same value-copy semantics: the
Kwan recursion snapshots and restores whole states for backtracking, so
``State.copy()`` is cheap-by-design (a handful of small numpy arrays).

Truth tables for all gates are kept in one contiguous ``uint32[capacity, 8]``
array so a device sweep can consume them without per-gate marshalling.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..core import boolfunc as bf
from ..core import ttable as tt

MAX_GATES = 500          # reference: state.h:26
NO_GATE = 0xFFFF         # reference: state.h:30 ((gatenum)-1)

# Per-gate-type CNF-size weights for the SAT metric (reference:
# get_sat_metric, state.c:168-191).  Indexed by gate_type enum value.
SAT_METRIC = {
    bf.FALSE_GATE: 1,
    bf.AND: 7,
    bf.A_AND_NOT_B: 4,
    bf.A: 4,
    bf.NOT_A_AND_B: 7,
    bf.B: 4,
    bf.XOR: 12,
    bf.OR: 7,
    bf.NOR: 7,
    bf.XNOR: 12,
    bf.NOT_B: 4,
    bf.A_OR_NOT_B: 7,
    bf.NOT_A: 4,
    bf.NOT_A_OR_B: 7,
    bf.NAND: 7,
    bf.TRUE_GATE: 1,
    bf.NOT: 4,
    bf.IN: 0,
}

INT_MAX = 2**31 - 1


def get_sat_metric(gate_type: int) -> int:
    return SAT_METRIC[gate_type]


@dataclass
class Gate:
    """One graph node (reference: state.h:72-79)."""

    type: int                 # gate_type enum value
    in1: int = NO_GATE
    in2: int = NO_GATE
    in3: int = NO_GATE
    function: int = 0         # 8-bit LUT truth table for LUT gates


class State:
    """Whole search state: gate list + output map + search budgets.

    ``tables`` rows [0, num_gates) hold each gate's truth table; the array
    over-allocates geometrically so appends are amortized O(1) and the live
    prefix can be handed to device sweeps as one slice.
    """

    __slots__ = (
        "max_sat_metric",
        "sat_metric",
        "max_gates",
        "gates",
        "outputs",
        "tables",
    )

    def __init__(self) -> None:
        self.max_sat_metric: int = INT_MAX
        self.sat_metric: int = 0
        self.max_gates: int = MAX_GATES
        self.gates: List[Gate] = []
        self.outputs: List[int] = [NO_GATE] * 8
        self.tables: np.ndarray = np.zeros((16, tt.N_WORDS), dtype=np.uint32)

    # -- construction -----------------------------------------------------

    @classmethod
    def init_inputs(cls, num_inputs: int) -> "State":
        """Fresh state with the S-box input variables as IN gates 0..n-1
        (reference: sboxgates.c:1136-1152)."""
        st = cls()
        for i in range(num_inputs):
            st._append(Gate(bf.IN), tt.input_table(i))
        return st

    @classmethod
    def from_numpy(
        cls,
        gates,
        tables,
        outputs=None,
        *,
        max_gates: int = MAX_GATES,
        max_sat_metric: int = INT_MAX,
        sat_metric: Optional[int] = None,
    ) -> "State":
        """Builds a state from plain arrays — the form in which another
        implementation's state (the JAX package's, in the parity tests)
        crosses over: ``gates`` int[G, 5] rows (type, in1, in2, in3,
        function), ``tables`` uint32[G, 8], ``outputs`` int[8].

        Every table is recomputed from the gate list and must equal the
        given one (ValueError otherwise).  ``sat_metric`` defaults to the
        accumulated metric of the non-LUT gates, as :meth:`add_gate`
        builds it."""
        gates = np.asarray(gates, dtype=np.int64).reshape(-1, 5)
        tables = np.asarray(tables, dtype=np.uint32).reshape(-1, tt.N_WORDS)
        if gates.shape[0] != tables.shape[0]:
            raise ValueError(
                f"{gates.shape[0]} gates but {tables.shape[0]} tables"
            )
        st = cls()
        sat = 0
        for i, (gtype, i1, i2, i3, func) in enumerate(gates.tolist()):
            if gtype == bf.IN:
                table = tt.input_table(i)
            elif gtype == bf.LUT:
                table = tt.eval_lut(
                    func, st.tables[i1], st.tables[i2], st.tables[i3]
                )
            elif gtype == bf.NOT:
                table = ~st.tables[i1]
            else:
                table = tt.eval_gate2(gtype, st.tables[i1], st.tables[i2])
            if not np.array_equal(table, tables[i]):
                raise ValueError(f"table of gate {i} does not match its gate")
            if gtype != bf.LUT:
                sat += get_sat_metric(gtype)
            st._append(Gate(gtype, i1, i2, i3, func), table)
        if outputs is not None:
            st.outputs = [int(o) for o in outputs]
        st.max_gates = max_gates
        st.max_sat_metric = max_sat_metric
        st.sat_metric = sat if sat_metric is None else sat_metric
        return st

    def to_numpy(self):
        """(gates int64[G, 5], tables uint32[G, 8], outputs int64[8]) — the
        inverse of :meth:`from_numpy`."""
        gates = np.array(
            [(g.type, g.in1, g.in2, g.in3, g.function) for g in self.gates],
            dtype=np.int64,
        ).reshape(-1, 5)
        return (
            gates,
            self.live_tables().copy(),
            np.asarray(self.outputs, dtype=np.int64),
        )

    @property
    def num_gates(self) -> int:
        return len(self.gates)

    @property
    def num_inputs(self) -> int:
        """IN gates always form the prefix (reference: state.c:193-199)."""
        n = 0
        for g in self.gates:
            if g.type != bf.IN:
                break
            n += 1
        return n

    def table(self, gid: int) -> np.ndarray:
        assert 0 <= gid < self.num_gates
        return self.tables[gid]

    def live_tables(self) -> np.ndarray:
        """The ``uint32[num_gates, 8]`` prefix consumed by device sweeps."""
        return self.tables[: self.num_gates]

    def copy(self) -> "State":
        st = State.__new__(State)
        st.max_sat_metric = self.max_sat_metric
        st.sat_metric = self.sat_metric
        st.max_gates = self.max_gates
        st.gates = [Gate(g.type, g.in1, g.in2, g.in3, g.function) for g in self.gates]
        st.outputs = list(self.outputs)
        st.tables = self.tables.copy()
        return st

    # -- mutation ---------------------------------------------------------

    def _append(self, gate: Gate, table: np.ndarray) -> int:
        if self.num_gates >= self.tables.shape[0]:
            new = np.zeros((self.tables.shape[0] * 2, tt.N_WORDS), dtype=np.uint32)
            new[: self.num_gates] = self.tables[: self.num_gates]
            self.tables = new
        self.tables[self.num_gates] = table
        self.gates.append(gate)
        return self.num_gates - 1

    def add_gate(self, gate_type: int, gid1: int, gid2: int, metric: int) -> int:
        """Appends a 2-input gate (or NOT); returns its id, or NO_GATE if an
        input is missing or a budget is exceeded (reference: add_gate,
        sboxgates.c:97-128)."""
        if gid1 == NO_GATE or (gid2 == NO_GATE and gate_type != bf.NOT):
            return NO_GATE
        if self.num_gates > self.max_gates:
            return NO_GATE
        if metric == SAT and self.sat_metric > self.max_sat_metric:
            return NO_GATE
        assert gate_type not in (bf.IN, bf.LUT)
        assert gid1 < self.num_gates
        assert gid2 < self.num_gates or gate_type == bf.NOT
        assert gid1 != gid2
        self.sat_metric += get_sat_metric(gate_type)
        if gate_type == bf.NOT:
            table = ~self.tables[gid1]
            gid2 = NO_GATE
        else:
            table = tt.eval_gate2(gate_type, self.tables[gid1], self.tables[gid2])
        return self._append(Gate(gate_type, gid1, gid2), table)

    def add_lut(self, func: int, gid1: int, gid2: int, gid3: int) -> int:
        """Appends a 3-input LUT gate (reference: add_lut, sboxgates.c:130-146)."""
        if NO_GATE in (gid1, gid2, gid3) or self.num_gates > self.max_gates:
            return NO_GATE
        assert gid1 < self.num_gates and gid2 < self.num_gates and gid3 < self.num_gates
        assert gid1 != gid2 and gid2 != gid3 and gid3 != gid1
        table = tt.eval_lut(func, self.tables[gid1], self.tables[gid2], self.tables[gid3])
        return self._append(Gate(bf.LUT, gid1, gid2, gid3, function=func), table)

    def add_not_gate(self, gid: int, metric: int) -> int:
        if gid == NO_GATE:
            return NO_GATE
        return self.add_gate(bf.NOT, gid, NO_GATE, metric)

    def add_and_gate(self, gid1: int, gid2: int, metric: int) -> int:
        if gid1 == NO_GATE or gid2 == NO_GATE:
            return NO_GATE
        if gid1 == gid2:
            return gid1
        return self.add_gate(bf.AND, gid1, gid2, metric)

    def add_or_gate(self, gid1: int, gid2: int, metric: int) -> int:
        if gid1 == NO_GATE or gid2 == NO_GATE:
            return NO_GATE
        if gid1 == gid2:
            return gid1
        return self.add_gate(bf.OR, gid1, gid2, metric)

    def add_xor_gate(self, gid1: int, gid2: int, metric: int) -> int:
        if gid1 == NO_GATE or gid2 == NO_GATE:
            return NO_GATE
        return self.add_gate(bf.XOR, gid1, gid2, metric)

    def add_boolfunc_2(self, fun: bf.BoolFunc, gid1: int, gid2: int, metric: int) -> int:
        """Materializes a 2-input BoolFunc, adding NOT gates for its
        polarities (reference: add_boolfunc_2, sboxgates.c:184-204)."""
        assert fun.num_inputs == 2
        if gid1 == NO_GATE or gid2 == NO_GATE or self.num_gates > self.max_gates:
            return NO_GATE
        if metric == SAT and self.sat_metric > self.max_sat_metric:
            return NO_GATE
        if fun.not_a:
            gid1 = self.add_not_gate(gid1, metric)
        if fun.not_b:
            gid2 = self.add_not_gate(gid2, metric)
        gid = self.add_gate(fun.fun1, gid1, gid2, metric)
        if fun.not_out:
            gid = self.add_not_gate(gid, metric)
        return gid

    def add_boolfunc_3(
        self, fun: bf.BoolFunc, gid1: int, gid2: int, gid3: int, metric: int
    ) -> int:
        """Materializes a 3-input BoolFunc as fun2(fun1(A,B),C) plus NOTs
        (reference: add_boolfunc_3, sboxgates.c:206-229)."""
        assert fun.num_inputs == 3
        if gid1 == NO_GATE or gid2 == NO_GATE or gid3 == NO_GATE:
            return NO_GATE
        if self.num_gates > self.max_gates:
            return NO_GATE
        if metric == SAT and self.sat_metric > self.max_sat_metric:
            return NO_GATE
        if fun.not_a:
            gid1 = self.add_not_gate(gid1, metric)
        if fun.not_b:
            gid2 = self.add_not_gate(gid2, metric)
        if fun.not_c:
            gid3 = self.add_not_gate(gid3, metric)
        out1 = self.add_gate(fun.fun1, gid1, gid2, metric)
        out = self.add_gate(fun.fun2, out1, gid3, metric)
        if fun.not_out:
            out = self.add_not_gate(out, metric)
        return out

    def replay_gate(
        self,
        gate_type: int,
        gid1: int,
        gid2: int,
        gid3: int = NO_GATE,
        function: int = 0,
    ) -> int:
        """Appends a gate WITHOUT budget checks: the replay of a result the
        native engines computed, which enforced the budgets during their
        search.  The mux recursion raises budgets for a while (the OR
        branch runs under the AND branch's size, sboxgates.c:539-543), so
        an adopted circuit may exceed the original budgets, as the Python
        engine's may.  Tables and the SAT metric are recomputed here."""
        assert gate_type != bf.IN
        if gate_type == bf.LUT:
            table = tt.eval_lut(
                function, self.tables[gid1], self.tables[gid2],
                self.tables[gid3],
            )
            return self._append(
                Gate(bf.LUT, gid1, gid2, gid3, function=function), table
            )
        self.sat_metric += get_sat_metric(gate_type)
        if gate_type == bf.NOT:
            table = ~self.tables[gid1]
            gid2 = NO_GATE
        else:
            table = tt.eval_gate2(gate_type, self.tables[gid1], self.tables[gid2])
        return self._append(Gate(gate_type, gid1, gid2), table)

    # -- verification -----------------------------------------------------

    def verify_gate(self, gid: int, target: np.ndarray, mask: np.ndarray) -> None:
        """Always-on self-check that a returned gate realizes the target
        under the mask — the reference's ASSERT_AND_RETURN (sboxgates.h:31-44)."""
        if gid == NO_GATE:
            return
        if not bool(tt.eq_mask(self.tables[gid], target, mask)):
            raise AssertionError(
                f"gate {gid} does not match target under mask "
                f"(table {tt.table_as_hex(self.tables[gid])}, "
                f"target {tt.table_as_hex(target)})\n"
                "gate table:\n" + tt.ttable_text(self.tables[gid])
                + "target:\n" + tt.ttable_text(np.asarray(target))
            )


# Metric enum (reference: state.h:59)
GATES = 0
SAT = 1


def check_num_gates_possible(st: State, add: int, add_sat: int, metric: int) -> bool:
    """Budget pruning (reference: check_num_gates_possible, sboxgates.c:270-278)."""
    if metric == SAT and st.sat_metric + add_sat > st.max_sat_metric:
        return False
    if st.num_gates + add > st.max_gates:
        return False
    return True
