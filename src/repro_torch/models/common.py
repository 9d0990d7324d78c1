"""Shared model-building blocks as ``torch.nn`` modules.

Counterpart of ``repro/models/common.py``.  Every parameter is made by a
:class:`Maker`, with the JAX package's initialisation scales (fan-in
normal over ``shape[0]`` unless a scale is given), drawn from the
caller's ``torch.Generator``.  Parameter names follow the JAX package's
pytree keys, so :func:`load_numpy` copies its parameters in by name.

Every parameter also carries the logical names of its dims
(``logical_axes``, the names the JAX package's ``Maker.param`` takes),
which ``dist.sharding`` maps onto a mesh; ``Model.axes`` gathers them
in place of the JAX ``Maker``'s ``axes`` mode.

On a mesh the parameters are DTensors (``train.trainer.place``) and the
same code runs on them.  So every tensor a model makes itself (rope's
frequencies, positions, zero states) goes through ``dist.sharding.like``
to the mesh of the stream it meets, and :func:`zeros` makes a zero
state that way; off a mesh both are plain tensors, as before.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist.sharding import (constrain_rows_model, is_dtensor,
                                       leading_spec, like,
                                       local_shape_and_offset, mesh_sizes,
                                       placements, row_local, shard_like)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; ``"cuda"`` raises without a card
    (nothing falls back to the CPU) and ``"meta"`` builds shapes only."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the model zoo's device='cuda' needs a CUDA "
                           "device; pass device='cpu' to run on the CPU")
    if device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class Maker:
    """Parameter factory: ``param`` returns a parameter of ``dtype`` on
    ``device``, initialised as the JAX package's ``Maker.param`` does,
    with the dims' logical names as its ``logical_axes``.  Normal draws
    come from ``generator`` (on its own device) in fp32, scaled, then
    cast.  On the ``meta`` device nothing is drawn."""

    def __init__(self, device, dtype, generator: torch.Generator | None):
        self.device = torch.device(device)
        self.dtype = dtype
        self.generator = generator

    def param(self, shape: tuple[int, ...], axes: tuple[str, ...],
              init: str = "normal",
              scale: float | None = None) -> nn.Parameter:
        if len(shape) != len(axes):
            raise ValueError(f"shape {shape} and axes {axes} differ in rank")
        kw = dict(dtype=self.dtype, device=self.device)
        if init not in ("normal", "zeros", "ones"):
            raise ValueError(init)
        if self.device.type == "meta":
            t = torch.empty(shape, **kw)
        elif init == "zeros":
            t = torch.zeros(shape, **kw)
        elif init == "ones":
            t = torch.ones(shape, **kw)
        else:
            if scale is None:
                # fan-in scaling over the contracted (first) dim
                scale = 1.0 / np.sqrt(max(shape[0], 1))
            g = self.generator
            t = torch.randn(shape, generator=g, dtype=torch.float32,
                            device=self.device if g is None else g.device)
            t = (t * scale).to(**kw)
        p = nn.Parameter(t, requires_grad=False)
        p.logical_axes = tuple(axes)
        return p


# ---------------------------------------------------------------------------
# Normalisation
# ---------------------------------------------------------------------------

def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """Normalised in fp32, cast to x's dtype, then scaled in that dtype."""
    dtype = x.dtype
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dtype) * scale.to(dtype)


def layernorm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dtype)


class RMSNorm(nn.Module):
    def __init__(self, mk: Maker, dim: int, axis: str = "embed"):
        super().__init__()
        self.scale = mk.param((dim,), (axis,), init="ones")

    def forward(self, x):
        return rmsnorm(self.scale, x)


class LayerNorm(nn.Module):
    def __init__(self, mk: Maker, dim: int):
        super().__init__()
        self.scale = mk.param((dim,), ("embed",), init="ones")
        self.bias = mk.param((dim,), ("embed",), init="zeros")

    def forward(self, x):
        return layernorm(self.scale, self.bias, x)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """x: [..., seq, heads, head_dim], rotated over all of head_dim;
    positions: [..., seq].  The frequencies' denominator is ``half`` (as
    the JAX package writes it), and the rotation runs in fp32."""
    half = x.shape[-1] // 2
    freqs = like(1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                               device=x.device) / half)), x)
    angles = like(positions, x)[..., None].float() * freqs  # [..., seq, half]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     -1).to(x.dtype)


def sinusoidal_at(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embeddings of integer ``positions`` [...] -> [..., dim]
    fp32: the sines of every frequency, then the cosines."""
    half = dim // 2
    div = like(torch.exp(-np.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half),
        positions)
    ang = positions[..., None].float() * div
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def sinusoidal_positions(length: int, dim: int, device=None) -> torch.Tensor:
    return sinusoidal_at(torch.arange(length, device=device), dim)


def zeros(ref: torch.Tensor, shape, dtype=None) -> torch.Tensor:
    """Zeros of ``shape`` (``ref``'s dtype unless given) on ``ref``'s
    device and, when ``ref`` is a DTensor, replicated on its mesh."""
    return like(torch.zeros(shape, dtype=dtype or ref.dtype,
                            device=ref.device), ref)


def positions_of(ref: torch.Tensor, b: int, s: int) -> torch.Tensor:
    """Positions 0..s-1 of each of ``b`` rows, [b, s], on ``ref``'s
    device and mesh."""
    return like(torch.arange(s, device=ref.device).expand(b, s), ref)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def activation(name: str):
    """``gelu`` is the tanh approximation, ``jax.nn.gelu``'s default."""
    return {
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "silu": F.silu,
        "relu": F.relu,
        "relu2": lambda x: F.relu(x).square(),
    }[name]


# ---------------------------------------------------------------------------
# Embedding / unembedding, dense
# ---------------------------------------------------------------------------

def _gather_rows(tokens, table):
    return table[tokens]


def _vocab_parallel(tokens, table):
    """The rows of ``tokens`` from a DTensor ``table`` whose rows (the
    vocabulary) may be cut over ``"model"``: each rank looks up its own
    batch rows' tokens in its own rows, zeros where another rank holds
    the row, and the parts are summed over ``"model"`` (one of them
    nonzero, so the sum is exact), as the JAX package gathers from a
    table cut there.  No gradient flows: serving only."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    tokens = like(tokens, table)
    rows = placements(leading_spec(tuple(tokens.shape), mesh_sizes(mesh)),
                      tokens.ndim, mesh)
    out = tuple(Partial() if p.is_shard(0) else r
                for p, r in zip(table.placements, rows))
    first = local_shape_and_offset(table.shape, mesh, table.placements)[1][0]

    def lookup(tok, local):
        idx = tok.long() - first
        inside = (idx >= 0) & (idx < local.shape[0])
        got = local[idx.clamp(0, local.shape[0] - 1)]
        return torch.where(inside[..., None], got, got.new_zeros(()))
    got = local_map(lookup, out_placements=list(out),
                    in_placements=(rows, table.placements),
                    device_mesh=mesh, redistribute_inputs=True)(tokens, table)
    return got.redistribute(mesh, rows)


class Embed(nn.Module):
    def __init__(self, mk: Maker, vocab: int, dim: int):
        super().__init__()
        self.table = mk.param((vocab, dim), ("vocab", "embed"), scale=1.0)

    def forward(self, tokens):
        """The rows of ``tokens``.  On a mesh, when no gradient is wanted
        (serving), each rank looks its batch rows up in its own part of
        the table and the parts are summed (:func:`_vocab_parallel`);
        in training each rank gathers its own batch rows from the whole
        table (``dist.sharding.row_local``)."""
        table = self.table
        if is_dtensor(table) and not (torch.is_grad_enabled()
                                      and table.requires_grad):
            return _vocab_parallel(tokens, table)
        return row_local(_gather_rows, tokens, table, n_out=1, whole=(1,))

    def unembed(self, x):
        """Tied output head: ``x @ table^T``."""
        return x @ constrain_rows_model(self.table).to(x.dtype).t()


class Dense(nn.Module):
    """``dense`` without a bias (no ported model uses one)."""

    def __init__(self, mk: Maker, d_in: int, d_out: int,
                 axes: tuple[str, str], scale: float | None = None):
        super().__init__()
        self.w = mk.param((d_in, d_out), axes, scale=scale)

    def forward(self, x):
        return x @ self.w.to(x.dtype)


# ---------------------------------------------------------------------------
# The weights bridge
# ---------------------------------------------------------------------------

def _tensor(arr) -> torch.Tensor:
    """A copy of a numpy array (bf16 from ``ml_dtypes`` too) as a CPU
    tensor."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.tensor(arr.view(np.int16)).view(torch.bfloat16)
    return torch.tensor(arr)


#: the JAX package's stacked pytrees (scanned layers, per-application
#: norms): a leading axis over their members
STACKED = {"layers", "mamba_layers", "app_norms", "enc_layers", "dec_layers"}


def flatten_tree(tree, prefix: str = "") -> dict:
    """The JAX package's parameter pytree (nested dicts and lists of
    arrays) as ``{dotted name: array}``; the leading axis of a top-level
    :data:`STACKED` entry is unstacked into ``<key>.<i>.<name>``, and a
    list (``dense_layers``) is numbered as ``nn.ModuleList`` numbers."""
    flat = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, (list, tuple)):
            flat.update(flatten_tree(dict(enumerate(val)), name + "."))
        elif isinstance(val, dict):
            if key in STACKED and not prefix:
                for sub, arr in flatten_tree(val).items():
                    for i in range(arr.shape[0]):
                        flat[f"{key}.{i}.{sub}"] = arr[i]
            else:
                flat.update(flatten_tree(val, name + "."))
        else:
            flat[name] = val
    return flat


def load_numpy(module: nn.Module, tree) -> None:
    """Copy the JAX package's parameter pytree (numpy arrays, or tensors
    on any device) into ``module``'s parameters by name, in their layouts
    (no transposes); raises on a missing, extra or misshapen name.  A
    DTensor parameter takes its own shard of the whole array."""
    flat = flatten_tree(tree)
    params = dict(module.named_parameters())
    if set(flat) != set(params):
        raise KeyError(f"pytree and module differ: missing "
                       f"{sorted(set(params) - set(flat))}, extra "
                       f"{sorted(set(flat) - set(params))}")
    with torch.no_grad():
        for name, p in params.items():
            t = flat[name]
            t = t if isinstance(t, torch.Tensor) else _tensor(t)
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{name}: pytree shape {tuple(t.shape)}, "
                                 f"module shape {tuple(p.shape)}")
            p.copy_(shard_like(t, p))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host; bf16 (which numpy lacks)
    as fp32, exactly.  A DTensor is gathered whole first (a collective:
    every rank of its mesh calls this)."""
    t = t.detach()
    if is_dtensor(t):
        t = t.full_tensor()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def nest(flat: dict) -> dict:
    """The inverse of :func:`flatten_tree`: ``{dotted name: array or
    tensor}`` (a module's names) as the JAX package's pytree.  Under a
    top-level :data:`STACKED` key the members ``<key>.<i>.<name>`` are
    stacked on a new leading axis (``np.stack``, or ``torch.stack`` for
    tensors; a leaf of logical axes gains ``"layers"`` in front, as the
    JAX package's ``stacked_params`` names it); any other numbered level
    (``dense_layers``) becomes a list."""
    tree: dict = {}
    for name, leaf in flat.items():
        node = tree
        *path, last = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[last] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    def stack(members):
        first = members[0]
        if isinstance(first, dict):
            return {k: stack([m[k] for m in members]) for k in first}
        if isinstance(first, tuple):
            return ("layers",) + first
        return (torch.stack(members) if isinstance(first, torch.Tensor)
                else np.stack(members))

    out = {}
    for key, node in tree.items():
        node = listify(node)
        out[key] = (stack(node) if key in STACKED and isinstance(node, list)
                    else node)
    return out
