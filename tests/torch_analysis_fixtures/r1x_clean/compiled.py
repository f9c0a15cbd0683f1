"""Functions compiled where they are defined (never executed)."""
import torch


@torch.compile(dynamic=True)
def scale(x, k):
    return x * k


@torch.compile
def add(x, y):
    return x + y
