"""Decoder-only transformer LM: the ``dense``, ``moe`` and ``vlm``
families (counterpart of ``repro/models/transformer.py``).

The layers are a ``ModuleList`` run one after another, where the JAX
package scans a stacked pytree.  In ``"train"`` mode each layer of that
stack runs under ``torch.utils.checkpoint`` (non-reentrant) when
``remat`` is set, where the JAX package puts ``jax.checkpoint`` on its
scan body: the leading dense layers, outside its scan, are not
rematerialised.  The JAX package's ``REPRO_*`` toggles change no result
and have no counterpart.  A layer's
attention is GQA or MLA, its feed-forward an MLP or an MoE; the first
``first_k_dense`` layers (``dense_layers``) take an MLP of ``dense_d_ff``
whatever the rest take.  The decode cache is ``{"layers": (a, b)}``, plus
``"dense"`` for the leading dense layers, each stacked over its layers:
GQA's K and V ``[L, B, KVH, S, D]`` (head-major per layer, see
``models.attention``), MLA's latent ``[L, B, S, kvr]`` and rope part
``[L, B, S, dr]``; decode updates it in place.  Every layer returns the
MoE's load-balancing loss (None for an MLP layer); ``"train"`` mode
returns their sum beside the logits, and serving drops it.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models.common import (Dense, Embed, Maker, RMSNorm,
                                       positions_of, zeros)
from repro_torch.models.mlp import MLP
from repro_torch.models.moe import MoE


class DecoderLayer(nn.Module):
    """``_layer_params`` and ``_apply_layer``: an MLP of ``dense_ff`` when
    it is given (a leading dense layer), else an MoE or the config's
    MLP."""

    def __init__(self, mk: Maker, cfg, dense_ff: int | None = None):
        super().__init__()
        self.ln_attn = RMSNorm(mk, cfg.d_model)
        self.ln_mlp = RMSNorm(mk, cfg.d_model)
        self.attn = attn.MLA(mk, cfg) if cfg.mla else attn.GQA(mk, cfg)
        self.moe = self.mlp = None
        if dense_ff is None and cfg.moe_enabled:
            self.moe = MoE(mk, cfg.d_model, cfg.moe_d_ff, cfg.num_experts,
                           cfg.mlp_act, top_k=cfg.experts_per_token,
                           capacity_factor=cfg.capacity_factor,
                           num_shared=cfg.num_shared_experts,
                           shared_d_ff=cfg.shared_d_ff)
        else:
            self.mlp = MLP(mk, cfg.d_model, dense_ff or cfg.d_ff,
                           cfg.mlp_act)

    def forward(self, x, positions, mode: str, cache=None,
                position_idx=None):
        """mode 'train' | 'prefill' | 'decode'; returns (x, layer cache,
        the MoE's aux loss, fp32; None for an MLP layer)."""
        h = self.ln_attn(x)
        if mode == "decode":
            a, new_cache = self.attn.decode_attention(
                h, cache[0], cache[1], position_idx)
        else:
            a, new_cache = self.attn.self_attention(h, positions)
        x = x + a
        h = self.ln_mlp(x)
        if self.moe is None:
            f, aux = self.mlp(h), None
        else:
            f, aux = self.moe(h)
        return x + f, new_cache, aux


def _train_layer(layer, x, positions):
    """A layer in training: (x, aux), no cache."""
    x, _, aux = layer(x, positions, "train")
    return x, aux


def _run(layers, x, positions, mode, cache, position_idx):
    """Run ``layers`` in turn; returns (x, their prefill cache stacked, or
    ``cache`` itself at decode)."""
    new = ([], [])
    for i, layer in enumerate(layers):
        c = None if cache is None else (cache[0][i], cache[1][i])
        x, nc, _ = layer(x, positions, mode, c, position_idx)
        for acc, t in zip(new, nc):
            acc.append(t)
    if mode == "decode":
        return x, cache
    return x, tuple(torch.stack(t) for t in new)


class Decoder(nn.Module):
    """``decoder_params`` and ``decoder_forward``."""

    def __init__(self, mk: Maker, cfg):
        super().__init__()
        self.cfg = cfg
        self.embed = Embed(mk, cfg.vocab_size, cfg.d_model)
        self.ln_f = RMSNorm(mk, cfg.d_model)
        self.dense_layers = nn.ModuleList(
            DecoderLayer(mk, cfg, dense_ff=cfg.dense_d_ff)
            for _ in range(cfg.first_k_dense))
        self.layers = nn.ModuleList(
            DecoderLayer(mk, cfg)
            for _ in range(cfg.num_layers - cfg.first_k_dense))
        self.head = (None if cfg.tie_embeddings else
                     Dense(mk, cfg.d_model, cfg.vocab_size,
                           ("embed", "vocab"), scale=0.02))

    def forward(self, tokens, mode: str, cache=None, position_idx=None,
                prefix_embeds=None, remat: bool = True):
        """mode 'prefill' | 'decode' returns (logits, cache); 'train'
        returns (logits, aux), aux the layers' MoE losses summed.  tokens
        [B, S] (S == 1 to decode); position_idx [B] decode positions;
        prefix_embeds [B, P, d] (vlm) are put before the tokens at
        prefill and in training."""
        x = self.embed(tokens)
        if prefix_embeds is not None and mode != "decode":
            x = torch.cat([prefix_embeds.to(x.dtype), x], 1)
        b, s, _ = x.shape
        if mode == "decode":
            positions = position_idx[:, None]
        else:
            positions = positions_of(x, b, s)
        if mode == "train":
            return self._train(x, positions, remat)
        new_cache = {}
        if len(self.dense_layers):
            x, new_cache["dense"] = _run(
                self.dense_layers, x, positions, mode,
                None if cache is None else cache["dense"], position_idx)
        x, new_cache["layers"] = _run(
            self.layers, x, positions, mode,
            None if cache is None else cache["layers"], position_idx)
        x = self.ln_f(x)
        logits = (self.embed.unembed(x) if self.head is None
                  else self.head(x))
        return logits, new_cache

    def _train(self, x, positions, remat: bool):
        aux = zeros(x, (), torch.float32)
        for i, layer in enumerate((*self.dense_layers, *self.layers)):
            if remat and i >= len(self.dense_layers):
                x, a = checkpoint(_train_layer, layer, x, positions,
                                  use_reentrant=False)
            else:
                x, a = _train_layer(layer, x, positions)
            if a is not None:
                aux = aux + a
        x = self.ln_f(x)
        return (self.embed.unembed(x) if self.head is None
                else self.head(x)), aux
