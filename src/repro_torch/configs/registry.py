"""Architecture registry: ``--arch <id>`` resolution."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, ShapeConfig, SHAPES, reduced

_ARCHS = {
    "whisper-base": "whisper_base",
    "gemma-7b": "gemma_7b",
    "qwen2-72b": "qwen2_72b",
    "qwen1.5-110b": "qwen15_110b",
    "minitron-4b": "minitron_4b",
    "zamba2-1.2b": "zamba2_1p2b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "internvl2-26b": "internvl2_26b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "deepseek-v2-236b": "deepseek_v2_236b",
}

ARCH_IDS = tuple(_ARCHS)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCHS[arch]}")
    return mod.CONFIG


def get_shape(shape: str) -> ShapeConfig:
    return SHAPES[shape]


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells; long_500k only for sub-quadratic
    archs unless include_skipped."""
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES:
            if shape == "long_500k" and not cfg.supports_long_context:
                if include_skipped:
                    out.append((arch, shape, "SKIP(full-attention)"))
                continue
            out.append((arch, shape, "RUN") if include_skipped
                       else (arch, shape))
    return out
