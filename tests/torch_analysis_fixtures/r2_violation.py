"""R2 fixture (dirty twin): host-device syncs inside loops of a hot
module."""
import numpy as np
import torch


def drain(chunks, ev):
    total = 0
    for c in chunks:
        total += c.sum().item()
        host = c.cpu()
        rows = c.tolist()
        arr = np.asarray(c)
        torch.cuda.synchronize()
    while total > 0:
        total -= int(torch.count_nonzero(host))
        ev.synchronize()
    return total, rows, arr


def flag_loop(parts):
    out = []
    for p in parts:
        out.append(bool(torch.any(p)))
        out.append(p.numpy())
    return out
