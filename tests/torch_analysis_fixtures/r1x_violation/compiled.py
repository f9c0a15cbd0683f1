"""Functions compiled where they are defined (never executed)."""
import torch


@torch.compile
def scale(x, k):
    return x * k


def shift(x, s):
    return x + s


shift_c = torch.compile(shift)
