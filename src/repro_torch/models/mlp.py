"""Feed-forward blocks: gated (SwiGLU/GeGLU) and plain MLPs
(counterpart of ``repro/models/mlp.py``)."""

from __future__ import annotations

from torch import nn

from repro_torch.dist.sharding import constrain_batch
from repro_torch.models.common import Maker, activation

GATED = {"swiglu": "silu", "geglu": "gelu"}


class MLP(nn.Module):
    """``mlp_params`` and ``mlp``: ``w_gate``/``w_up`` [d_model, d_ff] and
    ``w_down`` [d_ff, d_model]; the plain kinds (``relu2``, ``gelu``) have
    no gate."""

    def __init__(self, mk: Maker, d_model: int, d_ff: int, kind: str):
        super().__init__()
        self.kind = kind
        if kind in GATED:
            self.w_gate = mk.param((d_model, d_ff), ("embed", "ffn"))
        self.w_up = mk.param((d_model, d_ff), ("embed", "ffn"))
        self.w_down = mk.param((d_ff, d_model), ("ffn", "embed"))

    def forward(self, x):
        """On a mesh the output (each rank's ffn columns' part) is summed
        and anchored to its batch over the data axes, so that the stream
        it joins stays whole over ``"model"``."""
        if self.kind in GATED:
            act = activation(GATED[self.kind])
            h = act(x @ self.w_gate.to(x.dtype)) * (x @ self.w_up.to(x.dtype))
        else:
            h = activation(self.kind)(x @ self.w_up.to(x.dtype))
        return constrain_batch(h @ self.w_down.to(x.dtype))
