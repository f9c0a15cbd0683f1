"""Durable checkpoint writes with an integrity digest.

Every state file is written to a temp file, ``fsync``'d and moved into place
with ``os.replace``, so the path always holds either the complete old bytes
or the complete new bytes.  A SHA-256 digest of the XML text is recorded in
the file as a trailing comment (``<!-- sbg:sha256=... -->``), which the
reference binary's parser ignores; the loader verifies it when present.
The file bytes are identical to those the JAX package writes for the same
state.  :func:`latest_valid_state` recovers the newest intact checkpoint of
a directory, and :func:`clean_stale_tmp` removes the temp files a crash
stranded.
"""

from __future__ import annotations

import hashlib
import os
import re
import tempfile
from typing import Optional, Tuple

from .faults import fault_point

#: Temp-file prefix for in-flight writes.
TMP_PREFIX = ".sbg-tmp-"

# Sampled once at import: mkstemp creates 0600 files, and os.replace would
# carry that mode onto the published checkpoint.
_UMASK = os.umask(0)
os.umask(_UMASK)

_DIGEST_RE = re.compile(r"<!-- sbg:sha256=([0-9a-f]{64}) -->\s*\Z")


class IntegrityError(Exception):
    """A checkpoint's recorded digest does not match its contents."""


def digest_text(text: str) -> str:
    return hashlib.sha256(text.encode("utf-8")).hexdigest()


def with_digest(text: str) -> str:
    """Appends the integrity digest as a trailing XML comment."""
    return f"{text}<!-- sbg:sha256={digest_text(text)} -->\n"


def split_digest(raw: str) -> Tuple[str, Optional[str]]:
    """(body, digest-or-None) — body is the text the digest covers."""
    m = _DIGEST_RE.search(raw)
    if m is None:
        return raw, None
    return raw[: m.start()], m.group(1)


def verify_digest(raw: str) -> str:
    """Returns the digest-covered body; raises :class:`IntegrityError` on a
    mismatch.  Files without a digest pass through unchanged."""
    body, digest = split_digest(raw)
    if digest is not None and digest_text(body) != digest:
        raise IntegrityError(
            f"checkpoint digest mismatch (recorded {digest[:12]}..., "
            f"computed {digest_text(body)[:12]}...): torn or corrupted file"
        )
    return body


def _fsync_dir(directory: str) -> None:
    """Best-effort directory fsync, so the rename itself is durable."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def durable_write_text(
    path: str, text: str,
    fault_sites: Tuple[Optional[str], Optional[str]] = (None, None),
) -> None:
    """Atomically replaces ``path`` with ``text`` (temp file in the same
    directory, fsync, ``os.replace``, best-effort directory fsync).

    ``fault_sites`` names the (mid-content, pre-replace) fault sites;
    checkpoint writes pass ``("ckpt.write", "ckpt.replace")``: a crash at
    the first leaves a torn temp file and the old checkpoint untouched, at
    the second a complete temp file and the old checkpoint."""
    directory = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(prefix=TMP_PREFIX, suffix=".tmp", dir=directory)
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            half = len(text) // 2
            f.write(text[:half])
            f.flush()
            if fault_sites[0]:
                fault_point(fault_sites[0])
            f.write(text[half:])
            f.flush()
            os.fchmod(f.fileno(), 0o666 & ~_UMASK)
            os.fsync(f.fileno())
        if fault_sites[1]:
            fault_point(fault_sites[1])
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(directory)


def clean_stale_tmp(directory: str) -> int:
    """Removes in-flight temp files a crash stranded; returns the count.
    Safe at resume time, when no writer is live."""
    removed = 0
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return 0
    for name in names:
        if name.startswith(TMP_PREFIX):
            try:
                os.unlink(os.path.join(directory, name))
                removed += 1
            except OSError:
                pass
    return removed


def latest_valid_state(directory: str):
    """(path, State) of the newest intact checkpoint in ``directory``, or
    None when no XML file there loads: digest verified (when recorded)
    and structurally valid.  Torn or corrupt files are skipped, newest
    first by (mtime, path)."""
    from ..graph.xmlio import StateLoadError, load_state

    try:
        names = [
            n for n in sorted(os.listdir(directory))
            if n.endswith(".xml") and not n.startswith(TMP_PREFIX)
        ]
    except OSError:
        return None

    def mtime(p: str) -> float:
        try:
            return os.path.getmtime(p)
        except OSError:
            return 0.0

    paths = [os.path.join(directory, n) for n in names]
    paths.sort(key=lambda p: (mtime(p), p), reverse=True)
    for path in paths:
        try:
            return path, load_state(path)
        except (OSError, StateLoadError):
            continue
    return None
