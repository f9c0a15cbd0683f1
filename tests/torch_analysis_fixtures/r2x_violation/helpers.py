"""Helpers that block on the device (never executed)."""
import torch


def count_hits(t):
    return t.sum().item()


def settle():
    torch.cuda.synchronize()


def settled_rows(t):
    settle()
    return t
