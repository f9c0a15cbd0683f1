"""R2 fixture (clean twin): one sync after the loop, host data converted
inside it, and the for-else body (which runs once)."""
import numpy as np
import torch


def drain(chunks):
    acc = torch.zeros(())
    for c in chunks:
        acc += c.sum()
        idx = np.asarray([1, 2, 3])
        rows = np.array(list(range(4)))
    else:
        torch.cuda.synchronize()
    return acc.item(), idx, rows


def once(x):
    flag = bool(torch.any(x))
    return flag, x.cpu(), x.tolist()


def stream(xs, ev):
    ev.record()
    for x in xs:
        x.add_(1)
    ev.synchronize()
    return xs
