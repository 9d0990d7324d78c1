"""What each rank runs in ``tests/test_torch_serve_mesh.py``: the port's
prefill and greedy decode steps on a mesh of the ranks of a process
group, the weights placed by the inference rules and the cache by
``cache_axes``.

The ranks start by the ``spawn`` method, so the functions they run live
in a module they can import by name, one that imports neither JAX nor
the JAX package.  Every function here returns picklable numpy and Python
values.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.dist.sharding import abstract_mesh
from repro_torch.launch.mesh import device_mesh
from repro_torch.models.api import build_model
from repro_torch.serve.engine import expand_cache
from repro_torch.train.trainer import place

#: the batch, the prompt's length and the greedy decode steps after the
#: prefill (``tests/_jax_serve_mesh_ref.py`` serves the same)
B, P, STEPS = 4, 8, 3


def case_id(arch: str, mesh: tuple, extra: tuple) -> str:
    tag = ",".join(f"{k}={v}" for k, v in extra) or "-"
    return f"{arch}|{mesh[0]}x{mesh[1]}|{tag}"


def config(arch: str, extra: tuple):
    """The reduced config of ``arch`` (fp32) with ``extra`` replaced."""
    return dataclasses.replace(reduced(get_config(arch)),
                               **{k: v for k, v in extra})


def inputs(cfg, seed: int = 0) -> dict:
    """Seeded prompts, and a vlm's prefix or an encdec model's frames."""
    rng = np.random.default_rng(seed)
    out = {"prompts": rng.integers(0, cfg.vocab_size, (B, P)).astype(
        np.int32)}
    if cfg.family == "vlm":
        out["prefix_embeds"] = (rng.standard_normal(
            (B, cfg.frontend_len, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return out


def max_len(cfg) -> int:
    """The decode cache's slots: the prompt, the steps, and a vlm's
    prefix (its first decode position is the prompt's length)."""
    return P + STEPS + 1 + (cfg.frontend_len if cfg.family == "vlm" else 0)


def whole(t) -> np.ndarray:
    t = t.full_tensor() if hasattr(t, "full_tensor") else t
    return t.detach().float().numpy().copy()


def flat(tree, prefix: str = "") -> dict:
    """``{"a/0": leaf}`` of a tree of dicts and tuples, the JAX package's
    key paths."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def serve(case, weights, ins: dict, mesh=None) -> dict:
    """``case`` (arch, mesh shape, extra) served from the JAX pytree
    ``weights``: prefill, the cache padded to :func:`max_len`, ``STEPS``
    greedy decode steps at positions ``P``, ``P + 1``, ...; on ``mesh`` (a
    named ``DeviceMesh``; every rank calls this) or, with None, in one
    process.  Returns the logits of the prefill and of each step, the
    greedy tokens, the prefill's and the last step's cache (whole, by key
    path), and on a mesh the placements of every parameter and cache
    leaf as text."""
    arch, _, extra = case
    cfg = config(arch, extra)
    model = build_model(cfg, device="cpu").load_numpy(weights)
    if mesh is not None:
        place(model, mesh, inference=True)
    kw = {k: v for k, v in ins.items() if k != "prompts"}
    logits, cache = model.prefill(ins["prompts"], **kw)
    out = {"logits": [whole(logits)], "tokens": [],
           "prefill_cache": {k: whole(v) for k, v in flat(cache).items()}}
    if mesh is not None:
        out["prefill_placements"] = {k: str(tuple(v.placements))
                                     for k, v in flat(cache).items()}
    cache = expand_cache(model, cache, B, max_len(cfg))
    tok = logits.argmax(-1)
    pos = torch.full((B,), P, dtype=torch.int32)
    for _ in range(STEPS):
        out["tokens"].append(whole(tok))
        logits, cache = model.decode_step(tok[:, None], cache, pos)
        out["logits"].append(whole(logits))
        tok = logits.argmax(-1)
        pos = pos + 1
    out["tokens"].append(whole(tok))
    out["cache"] = {k: whole(v) for k, v in flat(cache).items()}
    if mesh is not None:
        out["placements"] = {k: str(tuple(v.placements))
                             for k, v in flat(cache).items()}
        out["param_placements"] = {
            n: str(tuple(p.placements))
            for n, p in model.net.named_parameters()}
    return out


def serve_cases(rank: int, n: int, cases: list, weights: dict,
                ins: dict) -> dict:
    """Every case on its mesh of the ``n`` ranks: rank 0's results by case
    id, and every other rank's greedy tokens (its logits, gathered, are
    rank 0's)."""
    out = {}
    for case in cases:
        arch, shape, extra = case
        mesh = device_mesh(abstract_mesh(tuple(shape), ("data", "model")),
                           "cpu")
        cid = case_id(arch, tuple(shape), tuple(extra))
        got = serve(case, weights[cid], ins[cid], mesh)
        out[cid] = got if rank == 0 else {"tokens": got["tokens"]}
    return out
