"""Serving launcher: batched prefill + decode with the Engine
(counterpart of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-7b \\
        --batch 4 --prompt-len 32 --steps 16

Runs on the card (``--device cuda``, the default); ``--device cpu``
takes the kernels' plain versions.  Parameters are drawn from a
generator seeded 0 on the device; an encdec model's frames (and a vlm's
prefix) are drawn after the prompts from the same numpy generator, fp32
at scale 0.02, as the JAX package's launcher draws them.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs.base import reduced as reduce_cfg
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.models.api import build_model
from repro_torch.serve.engine import Engine, ServeConfig


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="gemma-7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def setup(args: argparse.Namespace, cfg=None):
    """The engine and its inputs: (engine, prompts, generate kwargs).
    ``cfg`` (a caller's change of ``args.arch``'s config, such as a cut
    depth) replaces the registry's."""
    cfg = cfg or get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg, layers=2, d_model=128, vocab=1024)
    model = build_model(cfg, device=args.device)
    engine = Engine(model, ServeConfig(
        max_len=args.prompt_len + args.steps + 1,
        temperature=args.temperature), device=model.device)

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    kwargs = {}
    if cfg.family in ("encdec", "vlm"):
        name = "frames" if cfg.family == "encdec" else "prefix_embeds"
        kwargs[name] = np.asarray(
            rng.standard_normal((args.batch, cfg.frontend_len, cfg.d_model)),
            np.float32) * 0.02
    return engine, prompts, kwargs


def main(argv=None) -> np.ndarray:
    args = parse(argv)
    engine, prompts, kwargs = setup(args)
    t0 = time.time()
    tokens = engine.generate(prompts, args.steps, **kwargs)
    dt = time.time() - t0
    print(f"generated {tokens.shape} in {dt:.2f}s "
          f"({args.batch * args.steps / dt:.1f} tok/s)")
    print(tokens[:, :12])
    return tokens


if __name__ == "__main__":
    main()
