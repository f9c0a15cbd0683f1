"""The kernel wrapper: the one site that may reach the entry point."""
from .. import _kernels

launches = {"scale": 0}


def scale(t):
    fn = _kernels.lib().sbgt_scale
    launches["scale"] += 1
    return fn(t)
