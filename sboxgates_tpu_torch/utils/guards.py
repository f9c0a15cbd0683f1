"""Runtime guards for the two costs a run should not pay silently:
compiles on the search path and hidden host syncs.

:func:`recompile_guard` counts the port's only run-time compiles, the
builds of ``_kernels.build()`` (the CUDA kernels, with nvcc) and
``native.build()`` (the host runtime, with the C++ compiler) that compile
inside the block (a build that finds its library up to date compiles
nothing), and raises :class:`RecompileError` past ``allowed``.

:func:`sync_guard` counts host syncs inside the block.  On the card it
uses ``torch.cuda.set_sync_debug_mode("warn")``: CUDA counts every
synchronising call (device-to-host copies, ``.item()``, stream and event
waits) and this guard counts its warnings.  On the CPU, where nothing
synchronises, it counts the calls that would: ``Tensor.item``,
``Tensor.cpu``, ``Tensor.tolist``, ``Tensor.numpy`` (``np.asarray`` of a
tensor included) and ``torch.cuda.synchronize``.  ``action="raise"``
raises :class:`SyncError` at the first sync past ``allowed``;
``action="count"`` only tallies.

Both guards change process-wide state while installed (the patched
methods, the debug mode): guard one region at a time.  Syncs made by
other threads in that time, the dispatch deadline's worker among them,
are counted too.
"""

from __future__ import annotations

import contextlib
import os
import traceback
import warnings
from dataclasses import dataclass, field
from typing import Iterator, List


class RecompileError(RuntimeError):
    """A kernel or runtime build compiled inside a recompile_guard."""


class SyncError(RuntimeError):
    """An unexpected host sync happened inside a sync_guard."""


@dataclass
class GuardReport:
    """Mutable tally yielded by both guards."""

    compiles: int = 0
    syncs: int = 0
    events: List[str] = field(default_factory=list)

    def note(self, kind: str, detail: str) -> None:
        if kind == "compile":
            self.compiles += 1
        else:
            self.syncs += 1
        if len(self.events) < 200:  # bounded: long runs
            self.events.append(f"{kind}: {detail}")


def compile_count() -> int:
    """Compiles run in this process so far by the kernel and runtime
    builds."""
    from .. import _kernels, native

    return _kernels.compiles + native.compiles


@contextlib.contextmanager
def recompile_guard(allowed: int = 0, label: str = "") -> Iterator[GuardReport]:
    """Raises :class:`RecompileError` when more than ``allowed`` builds
    compile inside the block."""
    report = GuardReport()
    before = compile_count()
    yield report
    for _ in range(compile_count() - before):
        report.note("compile", "kernel or host runtime build")
    if report.compiles > allowed:
        where = f" in {label}" if label else ""
        raise RecompileError(
            f"{report.compiles} build(s) compiled{where} (allowed {allowed})"
        )


#: The calls a CPU sync_guard counts: (owner, attribute) pairs.
def _sync_points():
    import torch

    return ((torch.Tensor, "item"), (torch.Tensor, "cpu"),
            (torch.Tensor, "tolist"), (torch.Tensor, "numpy"),
            (torch.cuda, "synchronize"))


class _SyncPatches:
    """Wraps the sync entry points of the CPU guard."""

    _MISSING = object()

    def __init__(self, hit):
        self._hit = hit
        self._saved: list = []

    def install(self) -> None:
        for owner, name in _sync_points():
            orig = getattr(owner, name)
            own = owner.__dict__.get(name, self._MISSING) if isinstance(
                owner, type) else orig
            label = f"{getattr(owner, '__name__', owner)}.{name}"

            def wrapper(*a, _orig=orig, _label=label, **k):
                self._hit(_label)
                return _orig(*a, **k)

            self._saved.append((owner, name, own))
            setattr(owner, name, wrapper)

    def uninstall(self) -> None:
        for owner, name, own in reversed(self._saved):
            if own is self._MISSING:
                delattr(owner, name)
            else:
                setattr(owner, name, own)
        self._saved.clear()


def _caller() -> str:
    """file:line of the innermost frame outside torch, warnings and this
    module: where a sync the CUDA debug mode reported came from."""
    for fr in reversed(traceback.extract_stack()[:-2]):
        f = fr.filename.replace(os.sep, "/")
        if "/torch/" in f or f.endswith(("/warnings.py", "/guards.py")):
            continue
        return f"{os.path.basename(f)}:{fr.lineno} {fr.name}"
    return "?"


@contextlib.contextmanager
def sync_guard(
    allowed: int = 0,
    action: str = "raise",
    label: str = "",
    device="cpu",
) -> Iterator[GuardReport]:
    """Counts host syncs inside the block (see the module docstring):
    with the CUDA debug mode when ``device`` is a CUDA device, else by
    patching the CPU's sync calls.  ``action="raise"`` raises
    :class:`SyncError` at the first sync past ``allowed``;
    ``action="count"`` only tallies into the yielded report."""
    if action not in ("raise", "count"):
        raise ValueError(f"sync_guard action must be raise|count, got {action!r}")
    import torch

    report = GuardReport()

    def hit(what: str) -> None:
        report.note("sync", what)
        if action == "raise" and report.syncs > allowed:
            raise SyncError(
                f"host sync #{report.syncs} (allowed {allowed}): {what} — "
                "batch the transfer or move it out of the guarded region"
            )

    if torch.device(device).type == "cuda":
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            prev_show = warnings.showwarning

            def show(message, category, *a, **k):
                # The debug mode's own one-time notice ("Synchronization
                # debug mode is a prototype feature ...") is not a sync.
                if "synchronizing CUDA operation" in str(message):
                    hit(f"{str(message).splitlines()[0][:120]} at {_caller()}")
                else:
                    prev_show(message, category, *a, **k)

            warnings.showwarning = show
            prev_mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield report
            finally:
                torch.cuda.set_sync_debug_mode(prev_mode)
    else:
        patches = _SyncPatches(hit)
        patches.install()
        try:
            yield report
        finally:
            patches.uninstall()
    if action == "raise" and report.syncs > allowed:
        where = f" in {label}" if label else ""
        raise SyncError(
            f"{report.syncs} host sync(s){where} (allowed {allowed}); "
            f"events: {report.events[:8]}"
        )
