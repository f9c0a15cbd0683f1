"""dynamic=True takes the scalar as a symbol; loops over tensors and
constant scalars specialize once."""
from .compiled import add, scale


def run(x, ys, n):
    for i in range(n):
        x = scale(x, i)
        x = add(x, 2)
    for y in ys:
        x = add(x, y)
    return x
