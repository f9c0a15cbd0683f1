"""Unbucketed operand shapes at dispatch sites (dirty twin): every
distinct shape is a merge key of its own."""
import torch

from .kernels import kernel_call


def sweep(items):
    n = len(items)
    ops = torch.zeros((n, 8), dtype=torch.int32)
    return kernel_call("gate_sweep", ops)


def resweep(chunks):
    for chunk in chunks:
        pad = torch.empty((len(chunk), 8))
        kernel_call("gate_sweep", pad)


def grow(count):
    buf = torch.ones((count, 8))
    return kernel_call("gate_sweep", buf)
