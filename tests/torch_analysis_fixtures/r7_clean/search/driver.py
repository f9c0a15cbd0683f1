"""The search layer goes through the wrapper; its thread entry is
pinned."""
import threading

from ..ops.scale import scale


def sweep(t):
    return scale(scale(t))


def work():
    return None


def spawn():
    threading.Thread(target=work).start()
