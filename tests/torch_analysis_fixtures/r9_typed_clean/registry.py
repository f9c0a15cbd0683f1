"""A registry that observes into its histograms under its own lock
(never executed)."""
import threading


class Histogram:
    def __init__(self):
        self.n = 0

    def observe(self, value):
        self.n += 1


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._hists = {}

    def observe(self, name, value):
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            h.observe(value)
