"""Loop-varying Python scalars into compiled functions of another module."""
from .compiled import scale, shift_c


def run(x, n):
    for i in range(n):
        x = scale(x, i)
        x = shift_c(x, s=i + 1)
    for j, _ in enumerate(range(3)):
        x = scale(x, k=j)
    return x
