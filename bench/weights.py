"""The weights of a run, drawn by the benchmark on the device from the
seed, and handed to the port's model and to the plain reference alike.

The model is built on the ``meta`` device (shapes only); every parameter
is then a view into one flat buffer of the served dtype, filled by a few
large ``normal_`` calls from a ``torch.Generator`` on the device seeded
with the run's seed, then scaled (or set to one or zero) leaf by leaf in
place.  The scales are the port's initialisation: fan-in normal over a
leaf's first dim, with the exceptions in :func:`init_of`.  The same seed
gives the same bits, so :func:`draw` can be repeated to get the initial
weights back after a training run has moved them.
"""

from __future__ import annotations

import math

import torch

#: elements a ``normal_`` call fills (under 2**31)
CHUNK = 1 << 30

#: leaves set to one, and to zero, by the last part of their name
ONES = ("scale", "d_skip")
ZEROS = ("conv_b", "a_log", "dt_bias", "bq", "bk", "bv", "bias")
#: fan-in scale replaced, by a part of the name
SCALES = {"embed.table": 1.0, "router": 0.02, "head.w": 0.02,
          "conv_w": 0.5}


def init_of(name: str, shape) -> tuple[str, float]:
    """(kind, scale) of the leaf ``name`` of ``shape``: ``"ones"``,
    ``"zeros"`` or ``"normal"`` with its standard deviation."""
    last = name.rsplit(".", 1)[-1]
    if last in ONES:
        return "ones", 1.0
    if last in ZEROS:
        return "zeros", 0.0
    for part, scale in SCALES.items():
        if name.endswith(part):
            return "normal", scale
    return "normal", 1.0 / math.sqrt(max(shape[0], 1))


def draw(named_shapes, seed: int, device, dtype) -> dict:
    """{name: tensor} for ``named_shapes`` ((name, shape) pairs), every
    tensor a view into one buffer of ``dtype`` on ``device``, drawn from
    ``seed``."""
    specs = [(n, tuple(s), *init_of(n, s)) for n, s in named_shapes]
    total = sum(math.prod(s) for _, s, _, _ in specs)
    buf = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    for off in range(0, total, CHUNK):
        buf[off:off + CHUNK].normal_(generator=gen)
    out, off = {}, 0
    for name, shape, kind, scale in specs:
        n = math.prod(shape)
        t = buf[off:off + n].view(shape)
        off += n
        if kind == "ones":
            t.fill_(1)
        elif kind == "zeros":
            t.zero_()
        elif scale != 1.0:
            t.mul_(scale)
        out[name] = t
    return out


def named_shapes(model) -> list:
    """(name, shape) of each of ``model``'s parameters, in order."""
    return [(n, tuple(p.shape)) for n, p in model.net.named_parameters()]


def install(model, weights: dict) -> None:
    """Make each of ``model``'s parameters the tensor of its name in
    ``weights`` (no copy), keeping its logical axes."""
    for prefix, mod in model.net.named_modules():
        for name, p in list(mod.named_parameters(recurse=False)):
            full = f"{prefix}.{name}" if prefix else name
            q = torch.nn.Parameter(weights[full], requires_grad=False)
            q.logical_axes = p.logical_axes
            setattr(mod, name, q)


def build(cfg, seed: int, device):
    """(the port's model for ``cfg`` with weights drawn from ``seed`` on
    ``device``, the weights {name: tensor})."""
    from repro_torch.models.api import build_model
    from repro_torch.models.common import DTYPES

    model = build_model(cfg, device="meta")
    weights = draw(named_shapes(model), seed, device, DTYPES[cfg.dtype])
    install(model, weights)
    return model, weights
