"""Whisper-style encoder-decoder (whisper-base) on the hand-written
attention kernels (counterpart of ``repro/models/encdec.py``).

The audio frontend is a stub, as in the JAX package: the encoder takes
precomputed frame embeddings [B, frontend_len, d_model].  LayerNorm, GELU
MLPs, sinusoidal positions, no rope.  The encoder's self attention is one
full ``ops.flash_attention`` a layer; the decoder's is causal, and its
cross attention one full ``ops.flash_attention`` of the prompt against
the encoder's frames.  A decode step runs two ``ops.flash_decode`` a
layer: self attention masked to ``position + 1`` keys, and cross
attention against the cached encoder K/V, all ``frontend_len`` keys.

The frames are cast to the model's dtype where the encoder takes them.
The JAX package keeps the frames' dtype, so given the serving CLI's fp32
frames its bf16 model computes the encoder and the cross K/V in fp32, and
its decoder's scan then refuses the fp32 residual stream the first cross
attention makes (ROADMAP, "Found in the reference"); with frames in the
model's dtype it computes what the port computes.

The decode cache is ``{"layers": {"self": (k, v), "cross": (k, v)}}``,
each head-major per layer: ``self`` [L, B, KVH, S, D], ``cross`` [L, B,
KVH, frontend_len, D].  Decode updates ``self`` in place.  In
``"train"`` mode every encoder and decoder layer runs under
``torch.utils.checkpoint`` (non-reentrant) when ``remat`` is set, where
the JAX package checkpoints both scan bodies.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.sharding import constrain_batch
from repro_torch.models import attention as attn
from repro_torch.models.common import (Embed, LayerNorm, Maker, like,
                                       sinusoidal_at, sinusoidal_positions,
                                       zeros)
from repro_torch.models.mlp import MLP


class EncoderLayer(nn.Module):
    """``_enc_layer_params``: full self attention and an MLP, each
    pre-normed."""

    def __init__(self, mk: Maker, cfg):
        super().__init__()
        self.ln_attn = LayerNorm(mk, cfg.d_model)
        self.attn = attn.GQA(mk, cfg)
        self.ln_mlp = LayerNorm(mk, cfg.d_model)
        self.mlp = MLP(mk, cfg.d_model, cfg.d_ff, cfg.mlp_act)

    def forward(self, x):
        x = constrain_batch(x)              # the JAX package's anchor
        a, _ = self.attn.self_attention(self.ln_attn(x), None, causal=False,
                                        use_rope=False)
        x = x + a
        return x + self.mlp(self.ln_mlp(x))


class DecoderLayer(EncoderLayer):
    """``_dec_layer_params``: causal self attention, cross attention to
    the encoder's output, an MLP."""

    def __init__(self, mk: Maker, cfg):
        super().__init__(mk, cfg)
        self.ln_cross = LayerNorm(mk, cfg.d_model)
        self.cross = attn.GQA(mk, cfg)

    def forward(self, x, mode, enc_out=None, cache=None, position_idx=None):
        """Returns (x, {"self": (k, v), "cross": (k, v)})."""
        x = constrain_batch(x)              # the JAX package's anchor
        h = self.ln_attn(x)
        if mode == "decode":
            a, self_kv = self.attn.decode_attention(
                h, *cache["self"], position_idx, use_rope=False)
        else:
            a, self_kv = self.attn.self_attention(h, None, use_rope=False)
        x = x + a
        h = self.ln_cross(x)
        if mode == "decode":
            cross_kv = cache["cross"]
            x = x + self.cross.cross_decode(h, *cross_kv)
        else:
            c, cross_kv = self.cross.cross_attention(h, enc_out)
            x = x + c
        x = x + self.mlp(self.ln_mlp(x))
        return x, {"self": self_kv, "cross": cross_kv}


def _train_layer(layer, x, enc_out):
    """A decoder layer in training: its new stream, no cache."""
    return layer(x, "train", enc_out)[0]


class EncDec(nn.Module):
    """``encdec_params``, ``encode`` and ``decode_stack``; the output head
    is the tied embedding."""

    def __init__(self, mk: Maker, cfg):
        super().__init__()
        self.cfg = cfg
        self.embed = Embed(mk, cfg.vocab_size, cfg.d_model)
        self.enc_layers = nn.ModuleList(EncoderLayer(mk, cfg)
                                        for _ in range(cfg.encoder_layers))
        self.enc_ln_f = LayerNorm(mk, cfg.d_model)
        self.dec_layers = nn.ModuleList(DecoderLayer(mk, cfg)
                                        for _ in range(cfg.num_layers))
        self.dec_ln_f = LayerNorm(mk, cfg.d_model)

    def encode(self, frames, remat: bool = False):
        """frames [B, T, d] (cast to the model's dtype) -> [B, T, d]; each
        layer under ``checkpoint`` with ``remat``."""
        dtype = self.embed.table.dtype
        _, t, d = frames.shape
        x = frames.to(dtype) + like(sinusoidal_positions(
            t, d, frames.device).to(dtype), frames)
        for layer in self.enc_layers:
            x = (checkpoint(layer, x, use_reentrant=False) if remat
                 else layer(x))
        return self.enc_ln_f(x)

    def forward(self, tokens, mode: str, cache=None, position_idx=None,
                frames=None, prefix_embeds=None, remat: bool = True):
        """mode 'prefill' (``frames`` [B, T, d] required) | 'decode'
        returns (logits, cache); 'train' (``frames`` required) returns
        (logits, aux), aux 0."""
        if prefix_embeds is not None:
            raise ValueError(f"{self.cfg.name} takes no prefix embeddings")
        x = self.embed(tokens)
        _, s, d = x.shape
        enc_out = None
        if mode == "decode":
            pos_emb = sinusoidal_at(position_idx, d)[:, None]
        else:
            if frames is None:
                raise ValueError(f"{self.cfg.name} needs frames to {mode}")
            enc_out = self.encode(frames, remat and mode == "train")
            pos_emb = like(sinusoidal_positions(s, d, x.device)[None], x)
        x = x + pos_emb.to(x.dtype)
        if mode == "train":
            for layer in self.dec_layers:
                x = (checkpoint(_train_layer, layer, x, enc_out,
                                use_reentrant=False) if remat
                     else _train_layer(layer, x, enc_out))
            return (self.embed.unembed(self.dec_ln_f(x)),
                    zeros(x, (), torch.float32))
        new = {"self": ([], []), "cross": ([], [])}
        for i, layer in enumerate(self.dec_layers):
            c = None if cache is None else {
                key: tuple(t[i] for t in cache["layers"][key])
                for key in new}
            x, nc = layer(x, mode, enc_out, c, position_idx)
            for key in new:
                for acc, t in zip(new[key], nc[key]):
                    acc.append(t)
        logits = self.embed.unembed(self.dec_ln_f(x))
        if mode == "decode":
            return logits, cache
        return logits, {"layers": {key: tuple(torch.stack(t) for t in kv)
                                   for key, kv in new.items()}}
