"""A hot loop calling sync-tainted helpers of another module."""
from .helpers import count_hits, settled_rows


def sweep(chunks):
    total = 0
    for c in chunks:
        total += count_hits(c)
        settled_rows(c)
    return total
