"""R1 fixture (dirty twin): compiled callables built inside loops, and
loop-varying Python scalars passed to torch.compile'd functions."""
import torch


@torch.compile
def step(x, k):
    return x * k


def shift(x, s):
    return x + s


shift_c = torch.compile(shift)


def build_each_time(xs):
    out = []
    for x in xs:
        f = torch.compile(shift)
        out.append(f(x, 1))
    return out


def script_each_time(x, n):
    while n:
        g = torch.jit.script(shift)
        n -= 1
    return g(x, 1)


def varying_scalar(x):
    for i in range(8):
        x = step(x, i)
    return x


def varying_alias(x, ys):
    for j, y in enumerate(ys):
        x = shift_c(x, j * 2)
    return x
