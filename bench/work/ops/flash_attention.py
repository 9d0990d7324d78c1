"""``ops.flash_attention``: q, k [B, S, H, D], v [B, S, H, Dv]; with a
graph the forward also writes the log-sum-exp and has a backward."""

import torch

from bench.work import kernels as kw
from bench.work import peaks


def work(q, k, v, causal=True, **_):
    b, s, h, d = q.shape
    grad = torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v))
    fwd = kw.flash_attention(b * h, s, k.shape[1], d, v.shape[3],
                             causal=causal, elt=q.element_size(), lse=grad)
    bwd = kw.flash_attention_bwd(b * h, s, k.shape[1], d, v.shape[3],
                                 causal=causal, elt=q.element_size()) \
        if grad else None
    return (lambda: fwd), peaks.product_rate(str(q.dtype).split(".")[1]), bwd
