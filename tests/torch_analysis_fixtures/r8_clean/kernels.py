"""Dispatch seam stub the pack's drivers call (never executed)."""


def kernel_call(name, *operands):
    return name, operands


def bucket_size(n):
    return max(64, n)
