"""Graph persistence: the reference's XML state format (gates.xsd).

Files written here are loadable by the reference binary and vice versa —
the XML carries pure structure (gate types, wiring, LUT functions, output
map); truth tables are recomputed on load exactly as the reference does
(state.c:338-356).

The save filename is ``O-GGG-MMMM-NNN-FFFFFFFF.xml`` (state.h:90-96) where
the fingerprint F is a Speck-round hash over the serialized state.  We
reproduce the reference's fingerprint *byte-exactly* (state.c:56-105) by
packing the same C struct layout (state header padded to 32 bytes, each gate
padded to 64), so identical circuits get identical filenames in both
implementations — and the same bytes as the JAX package's ``xmlio``.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

from ..core import boolfunc as bf
from ..core import ttable as tt
from .state import Gate, MAX_GATES, NO_GATE, State, get_sat_metric


class StateLoadError(Exception):
    """Raised when an XML state file fails validation."""


# -- fingerprint ----------------------------------------------------------


def _speck_round(pt1: int, pt2: int, k1: int) -> Tuple[int, int]:
    """One round of the Speck-like permutation (reference: state.c:56-63)."""
    pt1 = ((pt1 >> 7) | (pt1 << 9)) & 0xFFFF
    pt1 = (pt1 + pt2) & 0xFFFF
    pt2 = ((pt2 >> 14) | (pt2 << 2)) & 0xFFFF
    pt1 ^= k1
    pt2 ^= pt1
    return pt1, pt2


def state_fingerprint(st: State) -> int:
    """Unique-ish 32-bit graph hash (reference: state_fingerprint,
    state.c:68-105).

    The reference absorbs the raw bytes of a zeroed ``state`` struct with
    only max_gates/num_gates/outputs and the used gate prefix copied in.
    We serialize the identical layout: 32-byte header (two zeroed int32
    metrics, u16 max_gates, u16 num_gates, 8 x u16 outputs, 4 pad bytes),
    then 64 bytes per gate (32-byte table, int32 type, 3 x u16 inputs,
    u8 function, 21 pad bytes), all little-endian.
    """
    parts = [
        struct.pack(
            "<iiHH8H4x",
            0,
            0,
            st.max_gates & 0xFFFF,
            st.num_gates & 0xFFFF,
            *[o & 0xFFFF for o in st.outputs],
        )
    ]
    for i, g in enumerate(st.gates):
        parts.append(st.tables[i].astype("<u4").tobytes())
        parts.append(
            struct.pack(
                "<iHHHB21x",
                g.type,
                g.in1 & 0xFFFF,
                g.in2 & 0xFFFF,
                g.in3 & 0xFFFF,
                g.function & 0xFF,
            )
        )
    data = b"".join(parts)
    assert len(data) == 32 + 64 * st.num_gates
    fp1 = fp2 = 0
    for (word,) in struct.iter_unpack("<H", data):
        fp1, fp2 = _speck_round(fp1, fp2, word)
    for _ in range(22):
        fp1, fp2 = _speck_round(fp1, fp2, 0)
    return (fp1 << 16) | fp2


# -- save -----------------------------------------------------------------


def state_filename(st: State) -> str:
    """Save-file name (reference: save_state, state.c:107-125)."""
    out = ""
    for i in range(st.num_gates):
        for k in range(8):
            if st.outputs[k] == i:
                # Only the first bit mapped to a gate is recorded, matching
                # the reference's early break (state.c:112-120).
                out += str(k)
                break
    num_outputs = len(out)
    return "%d-%03d-%04d-%s-%08x.xml" % (
        num_outputs,
        st.num_gates - st.num_inputs,
        st.sat_metric,
        out,
        state_fingerprint(st),
    )


def state_to_xml(st: State) -> str:
    """Serializes a state to the reference's exact XML text format
    (state.c:133-164)."""
    lines = ['<?xml version="1.0" encoding="UTF-8" ?>', "<gates>"]
    for i in range(8):
        if st.outputs[i] != NO_GATE:
            lines.append('  <output bit="%d" gate="%d" />' % (i, st.outputs[i]))
    for g in st.gates:
        if g.type == bf.IN:
            lines.append('  <gate type="IN" />')
            continue
        if g.type == bf.LUT:
            lines.append('  <gate type="LUT" function="%02x">' % g.function)
        else:
            lines.append('  <gate type="%s">' % bf.GATE_NAMES[g.type])
        for gid in (g.in1, g.in2, g.in3):
            if gid != NO_GATE:
                lines.append('    <input gate="%d" />' % gid)
        lines.append("  </gate>")
    lines.append("</gates>")
    return "\n".join(lines) + "\n"


def save_state(st: State, directory: str = ".") -> str:
    """Durably writes the state; returns the path (reference: save_state,
    state.c:107-125 — which truncates in place; here the write is
    crash-safe: temp file + fsync + atomic ``os.replace``, with an
    integrity digest recorded in the file as a trailing XML comment the
    reference parser ignores).  At every instant the path holds either
    the complete old bytes or the complete new bytes."""
    import os

    from ..resilience.checkpoint import durable_write_text, with_digest

    path = os.path.join(directory, state_filename(st))
    durable_write_text(
        path, with_digest(state_to_xml(st)),
        fault_sites=("ckpt.write", "ckpt.replace"),
    )
    return path


# -- load -----------------------------------------------------------------


def _parse_doc(text: str):
    import xml.etree.ElementTree as ET

    try:
        return ET.fromstring(text)
    except ET.ParseError as e:
        raise StateLoadError(f"XML parse error: {e}") from e


def state_from_xml(text: str) -> State:
    """Parses and validates a state, recomputing all truth tables
    topologically (reference: load_state, state.c:260-411)."""
    root = _parse_doc(text)
    if root.tag != "gates":
        raise StateLoadError("root element is not <gates>")

    st = State()
    st.max_gates = MAX_GATES

    for node in root:
        if node.tag != "gate":
            continue
        typestr = node.get("type")
        if typestr is None or typestr not in bf.GATE_BY_NAME:
            raise StateLoadError(f"bad gate type {typestr!r}")
        gtype = bf.GATE_BY_NAME[typestr]

        func = 0
        funcstr = node.get("function")
        if funcstr is not None:
            try:
                func = int(funcstr, 16)
            except ValueError:
                raise StateLoadError(f"bad LUT function {funcstr!r}")
            if func <= 0 or func > 255:
                raise StateLoadError(f"bad LUT function {funcstr!r}")
        if gtype != bf.LUT and func != 0:
            raise StateLoadError("function attribute on non-LUT gate")

        inputs = [NO_GATE, NO_GATE, NO_GATE]
        inp = 0
        for child in node:
            if child.tag != "input":
                continue
            gatestr = child.get("gate")
            try:
                gid = int(gatestr)
            except (TypeError, ValueError):
                raise StateLoadError(f"bad input gate {gatestr!r}")
            if gid < 0 or gid >= st.num_gates:
                raise StateLoadError(f"input gate {gid} not yet defined")
            if inp >= 3:
                raise StateLoadError("too many inputs")
            inputs[inp] = gid
            inp += 1

        if st.num_gates >= MAX_GATES:
            raise StateLoadError(f"more than MAX_GATES={MAX_GATES} gates")

        if gtype <= bf.TRUE_GATE:
            if inp != 2:
                raise StateLoadError("2-input gate needs exactly 2 inputs")
            table = tt.eval_gate2(
                gtype, st.tables[inputs[0]], st.tables[inputs[1]]
            )
        elif gtype == bf.NOT:
            if inp != 1:
                raise StateLoadError("NOT gate needs exactly 1 input")
            table = ~st.tables[inputs[0]]
        elif gtype == bf.IN:
            if inp != 0:
                raise StateLoadError("IN gate takes no inputs")
            if st.num_gates >= 8:
                raise StateLoadError("more than 8 IN gates")
            if st.num_gates != 0 and st.gates[-1].type != bf.IN:
                raise StateLoadError("IN gates must form a contiguous prefix")
            table = tt.input_table(st.num_gates)
        elif gtype == bf.LUT:
            if inp != 3:
                raise StateLoadError("LUT gate needs exactly 3 inputs")
            table = tt.eval_lut(
                func, st.tables[inputs[0]], st.tables[inputs[1]], st.tables[inputs[2]]
            )
        else:
            raise StateLoadError(f"unsupported gate type {typestr}")

        st._append(Gate(gtype, inputs[0], inputs[1], inputs[2], func), table)

    for node in root:
        if node.tag != "output":
            continue
        try:
            bit = int(node.get("bit"))
            gid = int(node.get("gate"))
        except (TypeError, ValueError):
            raise StateLoadError("bad output attributes")
        if bit < 0 or bit >= 8:
            raise StateLoadError(f"bad output bit {bit}")
        if st.outputs[bit] != NO_GATE:
            raise StateLoadError(f"duplicate output bit {bit}")
        if gid < 0 or gid >= st.num_gates:
            raise StateLoadError(f"output gate {gid} not defined")
        st.outputs[bit] = gid

    # Recompute SAT metric; zeroed when any LUT is present (state.c:399-406).
    sat = 0
    for g in st.gates:
        if g.type == bf.LUT:
            sat = 0
            break
        sat += get_sat_metric(g.type)
    st.sat_metric = sat
    return st


def load_state(path: str) -> State:
    """Loads and validates a checkpoint: integrity digest first (when the
    file records one — reference-written files don't and are validated
    structurally), then the full structural parse.  Torn or corrupted
    files raise :class:`StateLoadError`."""
    from ..resilience.checkpoint import IntegrityError, verify_digest

    with open(path, "r", encoding="utf-8") as f:
        raw = f.read()
    try:
        body = verify_digest(raw)
    except IntegrityError as e:
        raise StateLoadError(str(e)) from e
    return state_from_xml(body)


# -- schema validation ----------------------------------------------------

_SCHEMA = None


def validate_xml(text: str) -> None:
    """Validates a state document against the shipped ``gates.xsd``
    contract (the formal interop schema; reference counterpart:
    gates.xsd).  Raises StateLoadError on violation.

    This is a strict contract check used by tests and available to
    callers; the loader itself (:func:`state_from_xml`) stays
    schema-library-free and enforces the structural rules directly, as
    the reference's load_state does (state.c:260-411).
    """
    global _SCHEMA
    from lxml import etree

    if _SCHEMA is None:
        import os

        path = os.path.join(os.path.dirname(__file__), "gates.xsd")
        _SCHEMA = etree.XMLSchema(etree.parse(path))
    try:
        doc = etree.fromstring(text.encode("utf-8"))
    except etree.XMLSyntaxError as e:
        raise StateLoadError(f"XML parse error: {e}") from e
    if not _SCHEMA.validate(doc):
        raise StateLoadError(
            f"schema violation: {_SCHEMA.error_log.last_error}"
        )
