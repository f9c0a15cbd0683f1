"""A launch timer that records under an attempt's gate lock, into the
registry (never executed).  ``h.observe`` in the registry is a
Histogram's, so the registry lock never reaches the gate lock: there is
no cycle, though both classes have an ``observe`` method."""
import threading


class Gate:
    def __init__(self):
        self.lock = threading.Lock()


class Timer:
    def __init__(self, registry):
        self.registry = registry

    def observe(self, key, seconds, gate):
        with gate.lock:
            self.registry.observe(key, seconds)
