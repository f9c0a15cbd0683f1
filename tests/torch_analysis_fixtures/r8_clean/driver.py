"""Bucket-disciplined operand shapes (clean twin): every axis derives
from a declared bucket ladder, the padding idiom ``bucket - n``
included; constants are static."""
import torch

from .kernels import bucket_size, kernel_call


def sweep(items):
    b = bucket_size(len(items))
    ops = torch.zeros((b, 8), dtype=torch.int32)
    return kernel_call("gate_sweep", ops)


def pad_tail(items, bucket):
    tail = torch.zeros((bucket - len(items), 8))
    return kernel_call("gate_sweep", tail)


def fixed_probe():
    probe = torch.full((64, 8), -1)
    return kernel_call("gate_sweep", probe)
