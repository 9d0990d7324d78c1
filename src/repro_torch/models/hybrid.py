"""Zamba2-style hybrid (zamba2-1.2b): Mamba-2 blocks with one *shared*
transformer block applied after every ``attn_every`` of them, weights
reused across applications, each application with an input norm of its
own (counterpart of ``repro/models/hybrid.py``).

The blocks run in spans of ``attn_every``, each followed by the shared
block; the ``num_layers % attn_every`` blocks left over run as a tail
span after the last application (zamba2: 38 = 6 x 6 + 2).  The output
head is always the tied embedding, as the JAX package's
``hybrid_forward`` computes it whatever ``tie_embeddings`` says.

The decode cache is ``{"mamba": {"conv": [L, B, k-1, di + 2gn], "ssm":
[L, B, H, P, N] fp32}, "kv": (k, v)}``, the shared block's K/V
head-major, ``[n_attn, B, KVH, S, D]`` (see ``models.attention``); decode
updates it in place.  In ``"train"`` mode the Mamba-2 blocks run under
``torch.utils.checkpoint`` (non-reentrant) when ``remat`` is set, and the
shared block does not, as the JAX package puts ``jax.checkpoint`` on its
Mamba scan body only.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.common import (Embed, Maker, RMSNorm, positions_of,
                                       zeros)
from repro_torch.models.mlp import MLP
from repro_torch.models.ssm_lm import run_blocks


class MambaBlock(nn.Module):
    """``_mamba_block_params``: a pre-norm Mamba-2 block with a
    residual."""

    def __init__(self, mk: Maker, cfg):
        super().__init__()
        self.ln = RMSNorm(mk, cfg.d_model)
        self.mamba = ssm.Mamba2(mk, cfg)

    def forward(self, x, state=None):
        y, new_state = self.mamba(self.ln(x), state)
        return x + y, new_state


class SharedBlock(nn.Module):
    """``_shared_block_params`` and ``shared_block``: attention and an MLP,
    each pre-normed, after the application's own norm."""

    def __init__(self, mk: Maker, cfg):
        super().__init__()
        self.ln_attn = RMSNorm(mk, cfg.d_model)
        self.attn = attn.GQA(mk, cfg)
        self.ln_mlp = RMSNorm(mk, cfg.d_model)
        self.mlp = MLP(mk, cfg.d_model, cfg.d_ff, cfg.mlp_act)

    def forward(self, x, app_norm, positions, mode, kv=None,
                position_idx=None):
        h = self.ln_attn(app_norm(x))
        if mode == "decode":
            a, new_kv = self.attn.decode_attention(h, kv[0], kv[1],
                                                   position_idx)
        else:
            a, new_kv = self.attn.self_attention(h, positions)
        x = x + a
        return x + self.mlp(self.ln_mlp(x)), new_kv


class Hybrid(nn.Module):
    """``hybrid_params`` and ``hybrid_forward``."""

    def __init__(self, mk: Maker, cfg):
        super().__init__()
        self.cfg = cfg
        self.embed = Embed(mk, cfg.vocab_size, cfg.d_model)
        self.mamba_layers = nn.ModuleList(MambaBlock(mk, cfg)
                                          for _ in range(cfg.num_layers))
        self.shared = SharedBlock(mk, cfg)
        self.app_norms = nn.ModuleList(
            RMSNorm(mk, cfg.d_model)
            for _ in range(cfg.num_layers // cfg.attn_every))
        self.ln_f = RMSNorm(mk, cfg.d_model)

    def forward(self, tokens, mode: str, cache=None, position_idx=None,
                prefix_embeds=None, remat: bool = True):
        """mode 'prefill' | 'decode' returns (logits, cache); 'train'
        returns (logits, aux), aux 0."""
        if prefix_embeds is not None:
            raise ValueError(f"{self.cfg.name} takes no prefix embeddings")
        x = self.embed(tokens)
        b, s, _ = x.shape
        if mode == "decode":
            positions = position_idx[:, None]
        else:
            positions = positions_of(x, b, s)
        every = self.cfg.attn_every
        if mode == "train":
            return self._train(x, positions, remat)
        convs, states, keys, values = [], [], [], []
        for i, layer in enumerate(self.mamba_layers):
            c = None if cache is None else {
                "conv": cache["mamba"]["conv"][i],
                "ssm": cache["mamba"]["ssm"][i]}
            x, nc = layer(x, c)
            if mode == "decode":
                c["conv"].copy_(nc["conv"])
                c["ssm"].copy_(nc["ssm"])
            convs.append(nc["conv"])
            states.append(nc["ssm"])
            if (i + 1) % every:
                continue
            app = (i + 1) // every - 1
            kv = None if cache is None else (cache["kv"][0][app],
                                             cache["kv"][1][app])
            x, (k, v) = self.shared(x, self.app_norms[app], positions, mode,
                                    kv, position_idx)
            keys.append(k)
            values.append(v)
        logits = self.embed.unembed(self.ln_f(x))
        if mode == "decode":
            return logits, cache
        return logits, {"mamba": {"conv": torch.stack(convs),
                                  "ssm": torch.stack(states)},
                        "kv": (torch.stack(keys), torch.stack(values))}

    def _train(self, x, positions, remat: bool):
        every = self.cfg.attn_every
        blocks = self.mamba_layers
        for app, norm in enumerate(self.app_norms):
            x = run_blocks(blocks[app * every:(app + 1) * every], x, remat)
            x, _ = self.shared(x, norm, positions, "train")
        x = run_blocks(blocks[len(self.app_norms) * every:], x, remat)
        return (self.embed.unembed(self.ln_f(x)),
                zeros(x, (), torch.float32))
