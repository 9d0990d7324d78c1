"""Batched serving engine: prefill -> greedy/temperature decode loop with
a fixed-capacity cache (counterpart of ``repro/serve/engine.py``).

Greedy decoding gives the JAX package's tokens.  Temperature sampling
draws from a ``torch.Generator`` seeded by ``ServeConfig.seed`` on the
model's device; ``jax.random.categorical`` cannot be reproduced, so its
samples differ from the JAX package's.

Kept for parity with the JAX package: with ``prefix_embeds`` the first
decode position is the prompt's length, not the prefix's plus the
prompt's.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.dist.sharding import is_dtensor, place_tree
from repro_torch.models.api import Model
from repro_torch.models.common import resolve_device


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 512
    temperature: float = 0.0   # 0 => greedy
    seed: int = 0


def _tree_map(fn, tree, spec):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], spec[k]) for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t, s) for t, s in zip(tree, spec))
    return fn(tree, spec)


def expand_cache(model: Model, cache, batch: int, max_len: int):
    """Pad a prefill cache (seq == prompt length) out to ``max_len``
    slots, in :meth:`Model.cache_spec`'s shapes and dtypes.  A cache of
    DTensors (a model on a mesh) is padded on each rank's shard, the
    grown dims whole there, then placed at the cache's shardings."""

    def pad(c, s):
        if c.shape == s.shape:
            return c.to(s.dtype)
        if any(a > b for a, b in zip(c.shape, s.shape)):
            raise ValueError(f"a prefill cache of {tuple(c.shape)} does not "
                             f"fit {tuple(s.shape)}")
        if is_dtensor(c):
            return _pad_shards(c, s)
        out = torch.zeros(s.shape, dtype=s.dtype, device=c.device)
        out[tuple(slice(0, n) for n in c.shape)] = c
        return out

    out = _tree_map(pad, cache, model.cache_spec(batch, max_len))
    if model.mesh is None:
        return out
    return place_tree(model.cache_axes(), out, model.mesh)


def _pad_shards(c, s):
    """A DTensor ``c`` zero-padded to ``s``'s shape: the dims that grow
    made whole on each rank (a gather only where one was cut), each
    rank's shard padded."""
    from torch.distributed.tensor import DTensor, Replicate

    grow = {d for d in range(c.ndim) if c.shape[d] != s.shape[d]}
    where = tuple(Replicate() if p.is_shard() and p.dim in grow else p
                  for p in c.placements)
    local = c.redistribute(c.device_mesh, where).to_local()
    out = local.new_zeros([s.shape[d] if d in grow else n
                           for d, n in enumerate(local.shape)],
                          dtype=s.dtype)
    out[tuple(slice(0, n) for n in local.shape)] = local
    return DTensor.from_local(out, c.device_mesh, where, run_check=False)


class Engine:
    """Serves ``model`` on ``device`` (``"cuda"`` by default, where the
    model must live; raises without a card)."""

    def __init__(self, model: Model, scfg: ServeConfig | None = None, *,
                 device="cuda"):
        device = resolve_device(device)
        if model.device != device:
            raise ValueError(f"the model is on {model.device}, the engine "
                             f"serves on {device}")
        self.model = model
        self.scfg = scfg or ServeConfig()
        #: seconds of the last ``generate``: prefill (with its first token)
        #: and the decode steps, each ended by a device synchronisation
        self.stats: dict = {}

    def generate(self, prompts, steps: int, frames=None,
                 prefix_embeds=None) -> np.ndarray:
        """prompts: [B, P] int; returns [B, steps] generated tokens.
        ``frames`` [B, T, d] are an encdec model's encoder input,
        ``prefix_embeds`` [B, P', d] a vlm's prefix."""
        model = self.model
        b, p = prompts.shape
        gen = None
        if self.scfg.temperature > 0:
            gen = torch.Generator(model.device).manual_seed(self.scfg.seed)
        t0 = time.perf_counter()
        logits, cache = model.prefill(prompts, prefix_embeds=prefix_embeds,
                                      frames=frames)
        cache = expand_cache(model, cache, b, self.scfg.max_len)
        tok = self._sample(logits, gen)
        self._sync()
        t1 = time.perf_counter()
        out = [tok]
        pos = torch.full((b,), p, dtype=torch.int32, device=model.device)
        for _ in range(steps - 1):
            logits, cache = model.decode_step(tok[:, None], cache, pos)
            tok = self._sample(logits, gen)
            out.append(tok)
            pos = pos + 1
        tokens = torch.stack(out, 1).to(torch.int32).cpu().numpy()
        self.stats = {"prefill_s": t1 - t0,
                      "decode_s": time.perf_counter() - t1,
                      "decode_steps": steps - 1}
        return tokens

    def _sync(self) -> None:
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    def _sample(self, logits, gen):
        if self.scfg.temperature <= 0:
            return logits.argmax(-1)
        probs = torch.softmax(logits.float() / self.scfg.temperature, -1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]
