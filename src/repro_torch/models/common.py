"""Shared model-building blocks as ``torch.nn`` modules.

Counterpart of ``repro/models/common.py``.  Every parameter is made by a
:class:`Maker`, with the JAX package's initialisation scales (fan-in
normal over ``shape[0]`` unless a scale is given), drawn from the
caller's ``torch.Generator``.  Parameter names follow the JAX package's
pytree keys, so :func:`load_numpy` copies its parameters in by name.

The JAX package's ``Maker`` also has an ``axes`` mode, which returns the
logical axis names that GSPMD sharding reads; the port has no such mode
(it waits for the model half of ``dist/sharding``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

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
    ``device``, initialised as the JAX package's ``Maker.param`` does.
    Normal draws come from ``generator`` (on its own device) in fp32,
    scaled, then cast.  On the ``meta`` device nothing is drawn."""

    def __init__(self, device, dtype, generator: torch.Generator | None):
        self.device = torch.device(device)
        self.dtype = dtype
        self.generator = generator

    def param(self, shape: tuple[int, ...], init: str = "normal",
              scale: float | None = None) -> nn.Parameter:
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
        return nn.Parameter(t, requires_grad=False)


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
    def __init__(self, mk: Maker, dim: int):
        super().__init__()
        self.scale = mk.param((dim,), init="ones")

    def forward(self, x):
        return rmsnorm(self.scale, x)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """x: [..., seq, heads, head_dim], rotated over all of head_dim;
    positions: [..., seq].  The frequencies' denominator is ``half`` (as
    the JAX package writes it), and the rotation runs in fp32."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions[..., None].float() * freqs       # [..., seq, half]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     -1).to(x.dtype)


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

class Embed(nn.Module):
    def __init__(self, mk: Maker, vocab: int, dim: int):
        super().__init__()
        self.table = mk.param((vocab, dim), scale=1.0)

    def forward(self, tokens):
        return self.table[tokens]

    def unembed(self, x):
        """Tied output head: ``x @ table^T``."""
        return x @ self.table.to(x.dtype).t()


class Dense(nn.Module):
    """``dense`` without a bias (no ported model uses one)."""

    def __init__(self, mk: Maker, d_in: int, d_out: int,
                 scale: float | None = None):
        super().__init__()
        self.w = mk.param((d_in, d_out), scale=scale)

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


def _flatten_numpy(tree, prefix: str = "") -> dict:
    """The JAX package's parameter pytree (nested dicts and lists of
    arrays) as ``{dotted name: array}``; the stacked ``layers`` axis of
    the scanned layers is unstacked into ``layers.<i>.<name>``, and a
    list (``dense_layers``) is numbered as ``nn.ModuleList`` numbers."""
    flat = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, (list, tuple)):
            flat.update(_flatten_numpy(dict(enumerate(val)), name + "."))
        elif isinstance(val, dict):
            if key == "layers" and not prefix:
                for sub, arr in _flatten_numpy(val).items():
                    for i in range(arr.shape[0]):
                        flat[f"layers.{i}.{sub}"] = arr[i]
            else:
                flat.update(_flatten_numpy(val, name + "."))
        else:
            flat[name] = val
    return flat


def load_numpy(module: nn.Module, tree) -> None:
    """Copy the JAX package's parameter pytree (numpy arrays) into
    ``module``'s parameters by name, in their layouts (no transposes);
    raises on a missing, extra or misshapen name."""
    flat = _flatten_numpy(tree)
    params = dict(module.named_parameters())
    if set(flat) != set(params):
        raise KeyError(f"pytree and module differ: missing "
                       f"{sorted(set(params) - set(flat))}, extra "
                       f"{sorted(set(flat) - set(params))}")
    with torch.no_grad():
        for name, p in params.items():
            t = _tensor(flat[name])
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{name}: pytree shape {tuple(t.shape)}, "
                                 f"module shape {tuple(p.shape)}")
            p.copy_(t)
