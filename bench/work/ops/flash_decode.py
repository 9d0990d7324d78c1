"""``ops.flash_decode``: q [B, sq, d] or [B, H, g, d] against k [B, (H,)
S, d], v [..., dv], ``lengths`` [B].  The keys the lengths need are summed
on the device (a 0-d tensor, read after the traced slice, so that no call
waits for the card)."""

import torch

from bench.work import kernels as kw
from bench.work import peaks


def work(q, k, v, lengths=None, **_):
    heads = q.shape[1] if q.ndim == 4 else 1
    if lengths is None:
        used = k.shape[-2] * q.shape[0] * heads
    else:
        used = torch.as_tensor(lengths).sum(dtype=torch.int64) * heads
    b = q.shape[0] * heads
    sq, d, dv = q.shape[-2], q.shape[-1], v.shape[-1]
    elt = q.element_size()
    return (lambda: kw.flash_decode(b, sq, d, dv, int(used), elt=elt),
            peaks.product_rate(str(q.dtype).split(".")[1]), None)
