"""R3 fixture (clean twin): side effects outside the capture and outside
compiled functions; the compiled functions return their values."""
import threading

import torch

COUNT = 0


class Replayer:
    def capture(self, g, x):
        with torch.cuda.graph(g):
            y = x * 2
        self.last = y
        return y


@torch.compile
def step(x):
    return x + 1


def driver(x):
    global COUNT
    COUNT += 1
    threading.Thread(target=print).start()
    return step(x)
