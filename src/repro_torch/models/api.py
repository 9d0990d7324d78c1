"""Unified model facade: ``build_model(cfg)`` -> :class:`Model` with
prefill / decode_step, the decode cache's shapes, the parameter count and
the weights bridge from the JAX package (counterpart of
``repro/models/api.py``).

A model lives on one device, ``"cuda"`` by default (raising without a
card); its parameters are drawn from the caller's ``torch.Generator``
(or one seeded 0 on that device).  Families ported: ``dense``, ``vlm``
and ``ssm``; ``moe`` (with MLA), ``hybrid`` and ``encdec``, and
``loss`` with training, wait for ROADMAP A.9(a) and A.9(c).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common, ssm_lm, transformer
from repro_torch.models.common import DTYPES, Maker

#: families whose modules are not ported yet, and the item porting them
PENDING = {"moe": "ROADMAP A.9(a) (MoE and MLA)",
           "hybrid": "ROADMAP A.9(a) (Mamba-2 and hybrid)",
           "encdec": "ROADMAP A.9(a) (encdec)"}


class Model(nn.Module):
    """One architecture's parameters (``net``, named as the JAX package's
    pytree) and its serving entry points."""

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        if cfg.family in PENDING:
            raise NotImplementedError(f"{cfg.name}: the {cfg.family} family "
                                      f"is not ported yet "
                                      f"({PENDING[cfg.family]})")
        if cfg.family not in ("dense", "vlm", "ssm"):
            raise ValueError(cfg.family)
        self.cfg = cfg
        device = common.resolve_device(device)
        if generator is None and device.type != "meta":
            generator = torch.Generator(device).manual_seed(0)
        mk = Maker(device, DTYPES[cfg.dtype], generator)
        self.net = (ssm_lm.SsmLM(mk, cfg) if cfg.family == "ssm"
                    else transformer.Decoder(mk, cfg))

    @property
    def device(self) -> torch.device:
        """Where the parameters live (after any ``.to``)."""
        return self.net.embed.table.device

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.cfg.dtype]

    # ---------------- serving ----------------
    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    @torch.no_grad()
    def prefill(self, tokens, prefix_embeds=None):
        """tokens [B, S] -> (logits of the last position [B, V], cache);
        ``prefix_embeds`` [B, P, d] (vlm) go before the tokens."""
        if prefix_embeds is not None:
            prefix_embeds = torch.as_tensor(prefix_embeds,
                                            device=self.device)
        logits, cache = self.net(self._tokens(tokens), "prefill",
                                 prefix_embeds=prefix_embeds)
        return logits[:, -1], cache

    @torch.no_grad()
    def decode_step(self, tokens, cache, position_idx):
        """tokens [B, 1] at positions ``position_idx`` [B] -> (logits
        [B, V], cache); ``cache`` (of :meth:`cache_spec`'s shapes) is
        updated in place and returned."""
        position_idx = torch.as_tensor(position_idx, device=self.device)
        logits, cache = self.net(self._tokens(tokens), "decode", cache=cache,
                                 position_idx=position_idx)
        return logits[:, -1], cache

    def cache_spec(self, batch: int, max_len: int):
        """The decode cache's shapes and dtypes, as tensors on the ``meta``
        device in the cache's structure."""
        cfg = self.cfg
        dt = self.dtype

        def spec(*shape, dtype=dt):
            return torch.empty(shape, dtype=dtype, device="meta")
        L = cfg.num_layers
        if cfg.family == "ssm":
            di = cfg.ssm_d_inner
            return {"layers": {
                "conv": spec(L, batch, cfg.ssm_d_conv - 1, di),
                "ssm": spec(L, batch, di, cfg.ssm_state,
                            dtype=torch.float32)}}
        kv = spec(L, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
        return {"layers": (kv, kv)}

    # ---------------- parameters ----------------
    def param_count(self) -> int:
        """Parameters of this configuration, counted on the ``meta``
        device (a full-size count allocates nothing)."""
        twin = Model(self.cfg, device="meta")
        return sum(p.numel() for p in twin.parameters())

    def load_numpy(self, tree) -> "Model":
        """Copy in the JAX package's parameter pytree, as numpy arrays
        (the ``layers`` axis unstacked, every layout kept as it is)."""
        common.load_numpy(self.net, tree)
        return self


def build_model(cfg: ModelConfig, *, device="cuda",
                generator: torch.Generator | None = None) -> Model:
    return Model(cfg, device=device, generator=generator)
