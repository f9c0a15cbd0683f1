"""A sync acknowledged at its source, a device-only helper, and a class
whose method shares its name with a torch function (never executed)."""
import torch


def verdict(t):
    # torchlint: ignore[R2x] deliberate compact-verdict sync: one flag per dispatch is the stream's contract
    return bool(t.any().item())


def on_device(t):
    return t * 2


class Table:
    @staticmethod
    def from_numpy(a):
        return a.tolist()
