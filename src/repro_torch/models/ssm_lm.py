"""Attention-free SSM LM (falcon-mamba-7b): Mamba-1 blocks one after
another (counterpart of ``repro/models/ssm_lm.py``).

The state cache is ``{"layers": {"conv": [L, B, k-1, di], "ssm": [L, B,
di, n] fp32}}``, the JAX package's layout; decode updates it in place.
In ``"train"`` mode every block runs under ``torch.utils.checkpoint``
(non-reentrant) when ``remat`` is set, as the JAX package checkpoints
its scan body.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.sharding import constrain_batch
from repro_torch.models import ssm
from repro_torch.models.common import Embed, Maker, RMSNorm, zeros


def block_output(block, x):
    """A residual block's new stream, its state dropped (training)."""
    return block(x)[0]


def run_blocks(blocks, x, remat: bool):
    """``blocks`` in turn in training, each under ``checkpoint`` with
    ``remat``."""
    for block in blocks:
        x = (checkpoint(block_output, block, x, use_reentrant=False)
             if remat else block_output(block, x))
    return x


class SsmBlock(nn.Module):
    """``_block_params``: a pre-norm Mamba-1 block with a residual."""

    def __init__(self, mk: Maker, cfg):
        super().__init__()
        self.ln = RMSNorm(mk, cfg.d_model)
        self.mamba = ssm.Mamba(mk, cfg)

    def forward(self, x, state=None):
        x = constrain_batch(x)              # the JAX package's anchor
        y, new_state = self.mamba(self.ln(x), state)
        return x + y, new_state


class SsmLM(nn.Module):
    """``ssm_lm_params`` and ``ssm_lm_forward``; the embeddings are tied
    (falcon-mamba ties them)."""

    def __init__(self, mk: Maker, cfg):
        super().__init__()
        self.cfg = cfg
        self.embed = Embed(mk, cfg.vocab_size, cfg.d_model)
        self.layers = nn.ModuleList(SsmBlock(mk, cfg)
                                    for _ in range(cfg.num_layers))
        self.ln_f = RMSNorm(mk, cfg.d_model)

    def forward(self, tokens, mode: str, cache=None, position_idx=None,
                prefix_embeds=None, remat: bool = True):
        """mode 'prefill' | 'decode' returns (logits, cache); 'train'
        returns (logits, aux), aux 0.  The recurrence needs no
        positions."""
        if prefix_embeds is not None:
            raise ValueError(f"{self.cfg.name} takes no prefix embeddings")
        x = self.embed(tokens)
        if mode == "train":
            x = run_blocks(self.layers, x, remat)
            return (self.embed.unembed(self.ln_f(x)),
                    zeros(x, (), torch.float32))
        convs, states = [], []
        for i, layer in enumerate(self.layers):
            c = None if cache is None else {
                "conv": cache["layers"]["conv"][i],
                "ssm": cache["layers"]["ssm"][i]}
            x, nc = layer(x, c)
            if mode == "decode":
                c["conv"].copy_(nc["conv"])
                c["ssm"].copy_(nc["ssm"])
            convs.append(nc["conv"])
            states.append(nc["ssm"])
        logits = self.embed.unembed(self.ln_f(x))
        if mode == "decode":
            return logits, cache
        return logits, {"layers": {"conv": torch.stack(convs),
                                   "ssm": torch.stack(states)}}
