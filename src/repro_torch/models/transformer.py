"""Decoder-only transformer LM: the ``dense`` and ``vlm`` families
(counterpart of ``repro/models/transformer.py``).

The layers are a ``ModuleList`` run one after another, where the JAX
package scans a stacked pytree; the JAX package's ``remat`` and its
``REPRO_*`` toggles change no result and have no counterpart.  The KV
cache is ``{"layers": (K, V)}``, each ``[L, B, KVH, S, D]`` (head-major
per layer, see ``models.attention``); decode updates it in place.

MoE layers, MLA and leading dense layers wait for ROADMAP A.9(a).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models.common import Dense, Embed, Maker, RMSNorm
from repro_torch.models.mlp import MLP

#: the ROADMAP item that ports what this module refuses
PENDING = "ROADMAP A.9(a)"


def _refuse_pending(cfg) -> None:
    for flag, what in (("moe_enabled", "MoE layers"), ("mla", "MLA"),
                       ("first_k_dense", "leading dense layers")):
        if getattr(cfg, flag):
            raise NotImplementedError(
                f"{cfg.name}: {what} are not ported yet ({PENDING})")


class DecoderLayer(nn.Module):
    """``_layer_params`` and ``_apply_layer`` for a dense layer."""

    def __init__(self, mk: Maker, cfg):
        super().__init__()
        self.ln_attn = RMSNorm(mk, cfg.d_model)
        self.ln_mlp = RMSNorm(mk, cfg.d_model)
        self.attn = attn.GQA(mk, cfg)
        self.mlp = MLP(mk, cfg.d_model, cfg.d_ff, cfg.mlp_act)

    def forward(self, x, positions, mode: str, cache=None,
                position_idx=None):
        """mode 'prefill' | 'decode'; returns (x, layer cache)."""
        h = self.ln_attn(x)
        if mode == "decode":
            a, new_cache = self.attn.decode_attention(
                h, cache[0], cache[1], position_idx)
        else:
            a, new_cache = self.attn.self_attention(h, positions)
        x = x + a
        return x + self.mlp(self.ln_mlp(x)), new_cache


class Decoder(nn.Module):
    """``decoder_params`` and ``decoder_forward``."""

    def __init__(self, mk: Maker, cfg):
        super().__init__()
        _refuse_pending(cfg)
        self.cfg = cfg
        self.embed = Embed(mk, cfg.vocab_size, cfg.d_model)
        self.ln_f = RMSNorm(mk, cfg.d_model)
        self.layers = nn.ModuleList(DecoderLayer(mk, cfg)
                                    for _ in range(cfg.num_layers))
        self.head = (None if cfg.tie_embeddings else
                     Dense(mk, cfg.d_model, cfg.vocab_size, scale=0.02))

    def forward(self, tokens, mode: str, cache=None, position_idx=None,
                prefix_embeds=None):
        """mode 'prefill' | 'decode'; returns (logits, cache).  tokens
        [B, S] (S == 1 to decode); position_idx [B] decode positions;
        prefix_embeds [B, P, d] (vlm) are put before the tokens at
        prefill."""
        x = self.embed(tokens)
        if prefix_embeds is not None and mode != "decode":
            x = torch.cat([prefix_embeds.to(x.dtype), x], 1)
        b, s, _ = x.shape
        if mode == "decode":
            positions = position_idx[:, None]
        else:
            positions = torch.arange(s, device=x.device).expand(b, s)
        new_k, new_v = [], []
        for i, layer in enumerate(self.layers):
            c = None if cache is None else (cache["layers"][0][i],
                                            cache["layers"][1][i])
            x, (k, v) = layer(x, positions, mode, c, position_idx)
            new_k.append(k)
            new_v.append(v)
        x = self.ln_f(x)
        logits = (self.embed.unembed(x) if self.head is None
                  else self.head(x))
        if mode == "decode":
            return logits, cache
        return logits, {"layers": (torch.stack(new_k), torch.stack(new_v))}
