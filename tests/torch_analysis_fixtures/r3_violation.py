"""R3 fixture (dirty twin): Python side effects inside a CUDA graph
capture and inside compiled functions."""
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
    global COUNT
    COUNT = COUNT + 1
    threading.Thread(target=print).start()
    return x + 1


def body(x):
    global COUNT
    COUNT += 1
    return x


body_c = torch.compile(body)
