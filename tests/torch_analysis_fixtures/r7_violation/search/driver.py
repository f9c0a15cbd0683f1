"""A search-layer site that launches the kernel past its wrapper, and a
thread entry that is not pinned."""
import threading

from .. import _kernels
from ..ops.scale import scale


def sweep(t):
    out = scale(t)
    return _kernels.lib().sbgt_scale(out)


def work():
    return None


def spawn():
    threading.Thread(target=work).start()
