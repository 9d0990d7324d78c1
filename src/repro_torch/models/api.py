"""Unified model facade: ``build_model(cfg)`` -> :class:`Model` with
loss / prefill / decode_step, the decode cache's shapes, the parameter
count, the weights bridge to and from the JAX package's pytree, and
the dry run's abstract inputs and logical-axes trees (counterpart of
``repro/models/api.py``).

A model lives on one device, ``"cuda"`` by default (raising without a
card); its parameters are drawn from the caller's ``torch.Generator``
(or one seeded 0 on that device) and made without ``requires_grad``:
a trainer turns it on (``train.trainer.make_train_step`` does).  Every
family of the JAX package is ported: ``dense``, ``moe`` (with MLA and
leading dense layers), ``vlm``, ``ssm`` (Mamba-1), ``hybrid`` (Mamba-2
with a shared attention block) and ``encdec``.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.dist.sharding import is_dtensor
from repro_torch.models import common, encdec, hybrid, ssm_lm, transformer
from repro_torch.models.common import DTYPES, Maker
from repro_torch.models.mlp import GATED


def gold_logits(logits: torch.Tensor, gold: torch.Tensor) -> torch.Tensor:
    """``logits[b, s, gold[b, s]]``: a plain tensor's by a gather, a
    DTensor's (its vocab cut over ``"model"``) by the vocabulary's mask
    summed, which each rank sums over its own columns."""
    if not is_dtensor(logits):
        return torch.gather(logits, -1, gold[..., None])[..., 0]
    vocab = common.like(torch.arange(logits.shape[-1], device=gold.device),
                        logits)
    return torch.where(gold[..., None] == vocab, logits, 0.0).sum(-1)


#: each family's network
NETS = {"dense": transformer.Decoder, "moe": transformer.Decoder,
        "vlm": transformer.Decoder, "ssm": ssm_lm.SsmLM,
        "hybrid": hybrid.Hybrid, "encdec": encdec.EncDec}


class Model(nn.Module):
    """One architecture's parameters (``net``, named as the JAX package's
    pytree) and its serving entry points."""

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        if cfg.family not in NETS:
            raise ValueError(cfg.family)
        self.cfg = cfg
        device = common.resolve_device(device)
        if generator is None and device.type != "meta":
            generator = torch.Generator(device).manual_seed(0)
        mk = Maker(device, DTYPES[cfg.dtype], generator)
        self.net = NETS[cfg.family](mk, cfg)

    @property
    def device(self) -> torch.device:
        """Where the parameters live (after any ``.to``)."""
        return self.net.embed.table.device

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.cfg.dtype]

    def _tokens(self, tokens) -> torch.Tensor:
        return self._input(tokens).long()

    def _input(self, x) -> torch.Tensor:
        """A batch entry (numpy, a tensor, or a DTensor already placed on
        the parameters' mesh) as a tensor on the model's device."""
        return x if is_dtensor(x) else torch.as_tensor(x, device=self.device)

    # ---------------- training ----------------
    def loss(self, batch: dict, remat: bool = True):
        """Next-token cross-entropy of ``batch`` (``tokens`` [B, S], and
        ``patches`` [B, P, d] for a vlm, ``frames`` [B, T, d] for encdec;
        numpy arrays or tensors), as the JAX package's ``Model.loss``:
        the logits of a vlm's prefix cut, fp32 log-softmax, ``loss = nll
        + 0.01 * aux`` with aux the MoE layers' load-balancing loss.
        ``remat`` rematerialises each layer's activations in the backward
        where the JAX package puts ``jax.checkpoint``.  Returns (loss,
        {"nll", "aux", "perplexity"}), 0-d fp32 tensors.  With the
        parameters on a mesh (DTensors) the batch comes placed on it
        (``train.trainer.place_batch``) and the results are replicated
        DTensors."""
        tokens = self._tokens(batch["tokens"])
        kw = {}
        if batch.get("patches") is not None:
            kw["prefix_embeds"] = self._input(batch["patches"])
        if batch.get("frames") is not None:
            kw["frames"] = self._input(batch["frames"])
        logits, aux = self.net(tokens, "train", remat=remat, **kw)
        if self.cfg.family == "vlm" and "prefix_embeds" in kw:
            logits = logits[:, kw["prefix_embeds"].shape[1]:]
        logits = logits[:, :-1].float()
        logz = torch.logsumexp(logits, -1)
        gold = gold_logits(logits, tokens[:, 1:])
        nll = (logz - gold).mean()
        return nll + 0.01 * aux, {"nll": nll, "aux": aux,
                                  "perplexity": torch.exp(nll)}

    # ---------------- serving ----------------

    @torch.no_grad()
    def prefill(self, tokens, prefix_embeds=None, frames=None):
        """tokens [B, S] -> (logits of the last position [B, V], cache);
        ``prefix_embeds`` [B, P, d] (vlm) go before the tokens, and
        ``frames`` [B, T, d] (encdec) are the encoder's input."""
        kw = {}
        if prefix_embeds is not None:
            kw["prefix_embeds"] = torch.as_tensor(prefix_embeds,
                                                  device=self.device)
        if frames is not None:
            if self.cfg.family != "encdec":
                raise ValueError(f"{self.cfg.name} takes no frames")
            kw["frames"] = torch.as_tensor(frames, device=self.device)
        logits, cache = self.net(self._tokens(tokens), "prefill", **kw)
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

    # ---------------- abstract specs (dry run) ----------------
    def batch_spec(self, shape: ShapeConfig) -> dict:
        """A cell's model inputs as ``meta`` tensors (shapes and dtypes,
        no data), as the JAX package's ``batch_spec``: decode takes
        ``tokens`` [B, 1] and ``position`` [B]; train and prefill take
        ``tokens`` [B, S] (a vlm's S less its prefix, given as
        ``patches``) and, for encdec, ``frames``."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len

        def spec(*dims, dtype=self.dtype):
            return torch.empty(dims, dtype=dtype, device="meta")
        if shape.kind == "decode":
            return {"tokens": spec(b, 1, dtype=torch.int32),
                    "position": spec(b, dtype=torch.int32)}
        out, text = {}, s
        if cfg.family == "vlm":
            text = s - cfg.frontend_len
            out["patches"] = spec(b, cfg.frontend_len, cfg.d_model)
        if cfg.family == "encdec":
            out["frames"] = spec(b, cfg.frontend_len, cfg.d_model)
        out["tokens"] = spec(b, text, dtype=torch.int32)
        return out

    def cache_spec(self, batch: int, max_len: int):
        """The decode cache's shapes and dtypes, as tensors on the ``meta``
        device in the cache's structure."""
        cfg = self.cfg
        dt = self.dtype

        def spec(*shape, dtype=dt):
            return torch.empty(shape, dtype=dtype, device="meta")
        L = cfg.num_layers - cfg.first_k_dense
        di = cfg.ssm_d_inner
        if cfg.family == "ssm":
            return {"layers": {
                "conv": spec(L, batch, cfg.ssm_d_conv - 1, di),
                "ssm": spec(L, batch, di, cfg.ssm_state,
                            dtype=torch.float32)}}

        def kv(n, seq):
            t = spec(n, batch, cfg.num_kv_heads, seq, cfg.head_dim)
            return (t, t)
        if cfg.family == "hybrid":
            gn = cfg.ssm_groups * cfg.ssm_state
            return {"mamba": {
                "conv": spec(L, batch, cfg.ssm_d_conv - 1, di + 2 * gn),
                "ssm": spec(L, batch, cfg.ssm_heads, di // cfg.ssm_heads,
                            cfg.ssm_state, dtype=torch.float32)},
                "kv": kv(L // cfg.attn_every, max_len)}
        if cfg.family == "encdec":
            return {"layers": {"self": kv(L, max_len),
                               "cross": kv(L, cfg.frontend_len)}}

        def layers(n):
            if cfg.mla:
                return (spec(n, batch, max_len, cfg.kv_lora_rank),
                        spec(n, batch, max_len, cfg.qk_rope_head_dim))
            return kv(n, max_len)
        out = {"layers": layers(L)}
        if cfg.first_k_dense:
            out["dense"] = layers(cfg.first_k_dense)
        return out

    def cache_axes(self):
        """The logical axes of :meth:`cache_spec`'s leaves, in its
        structure.  The KV caches are head-major, so their axes are the
        JAX package's ``cache_axes`` with ``kv_heads`` and ``kvseq``
        swapped; MLA's latent cache and the Mamba states keep its
        layout."""
        cfg = self.cfg
        kv = ("layers", "batch", "kv_heads", "kvseq", "head_dim")
        if cfg.family == "ssm":
            return {"layers": {
                "conv": ("layers", "batch", "conv", "ssm_inner"),
                "ssm": ("layers", "batch", "ssm_inner", "ssm_state")}}
        if cfg.family == "hybrid":
            return {"mamba": {
                "conv": ("layers", "batch", "conv", "ssm_inner"),
                "ssm": ("layers", "batch", "ssm_heads", "head_dim",
                        "ssm_state")},
                "kv": (kv, kv)}
        if cfg.family == "encdec":
            return {"layers": {"self": (kv, kv), "cross": (kv, kv)}}
        layer = ((("layers", "batch", "kvseq", "kv_lora"),
                  ("layers", "batch", "kvseq", "head_dim")) if cfg.mla
                 else (kv, kv))
        out = {"layers": layer}
        if cfg.first_k_dense:
            out["dense"] = layer
        return out

    # ---------------- parameters ----------------
    def axes(self) -> dict:
        """Every parameter's logical axes (``Maker.param``'s), in
        :meth:`numpy_tree`'s layout: a stacked leaf gains ``"layers"``
        in front, as in the JAX package's ``Model.axes``."""
        return common.nest({n: p.logical_axes
                            for n, p in self.net.named_parameters()})

    def shapes(self) -> dict:
        """The parameters as ``meta`` tensors in :meth:`numpy_tree`'s
        layout (the stacked leaves stacked): the twin of the JAX
        package's ``jax.eval_shape(model.init, key)``."""
        return common.nest({n: torch.empty(p.shape, dtype=p.dtype,
                                           device="meta")
                            for n, p in self.net.named_parameters()})

    def param_count(self) -> int:
        """Parameters of this configuration, counted on the ``meta``
        device (a full-size count allocates nothing)."""
        twin = Model(self.cfg, device="meta")
        return sum(p.numel() for p in twin.parameters())

    def active_param_count(self) -> int:
        """Parameters a token uses: the experts it is not routed to are
        left out (three matrices an expert for the gated kinds, two for
        the plain ones)."""
        total = self.param_count()
        cfg = self.cfg
        if not cfg.moe_enabled:
            return total
        per_expert = ((3 if cfg.mlp_act in GATED else 2) * cfg.d_model
                      * cfg.moe_d_ff)
        inactive = cfg.num_experts - cfg.experts_per_token
        return total - (cfg.num_layers - cfg.first_k_dense) * inactive \
            * per_expert

    def load_numpy(self, tree) -> "Model":
        """Copy in the JAX package's parameter pytree, as numpy arrays
        (the stacked axes of ``common.STACKED`` unstacked,
        ``dense_layers`` by index, every layout kept as it is)."""
        common.load_numpy(self.net, tree)
        return self

    def numpy_tree(self) -> dict:
        """The parameters as the JAX package's pytree of numpy arrays
        (``common.nest``: the ``STACKED`` axes restacked); bf16 as fp32,
        which holds every bf16 value exactly.  DTensors are gathered
        whole (a collective: every rank calls it)."""
        return common.nest({n: common.to_numpy(p)
                            for n, p in self.net.named_parameters()})

    def grad_tree(self) -> dict:
        """The parameters' gradients in :meth:`numpy_tree`'s layout (zeros
        for a parameter that has none)."""
        return common.nest({
            n: common.to_numpy(torch.zeros_like(p) if p.grad is None
                               else p.grad)
            for n, p in self.net.named_parameters()})


def build_model(cfg: ModelConfig, *, device="cuda",
                generator: torch.Generator | None = None) -> Model:
    return Model(cfg, device=device, generator=generator)
