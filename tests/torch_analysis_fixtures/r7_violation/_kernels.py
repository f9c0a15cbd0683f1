"""Miniature kernel library: the C entry points (never executed)."""
_SIGNATURES = {
    "sbgt_scale": ["p", "i"],
    "sbgt_orphan": ["p"],
}


def lib():
    return None
