"""The cross-process lock the package's two builders share.

``native.build()`` (the C++ host runtime) and ``_kernels.build()`` (the
CUDA kernels) each hold an exclusive ``flock`` on ``<build dir>/.build.lock``
while they check their digest stamp and compile: concurrent processes (test
workers, a crashed run and its resume) then compile once, the others
waiting and finding the stamp current.
"""

from __future__ import annotations

import contextlib
import fcntl
import os


@contextlib.contextmanager
def build_lock(directory: str):
    """Holds an exclusive lock on ``directory`` (which must exist) for the
    body of the ``with``."""
    fd = os.open(os.path.join(directory, ".build.lock"),
                 os.O_RDWR | os.O_CREAT, 0o666)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)  # closing the descriptor releases the lock
