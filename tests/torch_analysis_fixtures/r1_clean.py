"""R1 fixture (clean twin): compiled once outside the loop, dynamic=True
for scalar arguments, and loops whose targets are tensors."""
import torch


@torch.compile(dynamic=True)
def step(x, k):
    return x * k


@torch.compile
def add(x, y):
    return x + y


def shift(x, s):
    return x + s


SHIFT = torch.compile(shift, dynamic=True)


def hoisted(xs):
    f = torch.compile(shift)
    return [f(x, 1) for x in xs]


def dynamic_scalar(x):
    for i in range(8):
        x = step(x, i)
        x = SHIFT(x, i)
    return x


def tensor_loop(x, ys):
    for y in ys:
        x = add(x, y)
    for i in range(4):
        x = add(x, 3)
    return x
