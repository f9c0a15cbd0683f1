"""Miniature kernel library: the C entry points (never executed)."""
_SIGNATURES = {
    "sbgt_scale": ["p", "i"],
}


def lib():
    return None
