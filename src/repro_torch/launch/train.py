"""Training launcher (counterpart of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \\
        --steps 30 --batch 2 --seq 1024 --lr 1e-3 --ckpt-dir /tmp/ckpt \\
        --resume auto

Takes the JAX launcher's flags, plus ``--device`` (``cuda``, the
default; ``cpu`` runs the kernels' plain versions, with ``--reduced``).
Parameters are drawn from a generator seeded 0 on the device; batches
come from ``data.SyntheticLM``; the step is ``train.make_train_step``
with AdamW's warmup ``min(20, steps // 5 + 1)``, as the JAX launcher
sets it.  It prints the same ``step ...``, ``resumed from step N`` and
``done`` lines.  ``--production-mesh`` raises: a mesh of cards waits
for the multi-card path (ROADMAP A.7).

A checkpoint is labelled with the updates it holds: the step after
``n`` updates is saved as step ``n`` (every ``--ckpt-every`` updates and
at the end), and ``--resume auto`` continues with batch ``n``.  (The
JAX launcher labels its periodic saves one update early, so resuming
from one of them repeats a batch; its final save, which the CLI tests
resume from, is labelled as here.)
"""

from __future__ import annotations

import argparse
import time

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs.base import ShapeConfig, reduced as reduce_cfg
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.dist import elastic
from repro_torch.models.api import build_model
from repro_torch.train import optimizer as optlib
from repro_torch.train.trainer import (TrainConfig, load_state,
                                       make_train_step, state_tree)


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="gemma-7b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--reduced-layers", type=int, default=4)
    ap.add_argument("--reduced-dmodel", type=int, default=256)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default=None, choices=[None, "auto"])
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


class Run:
    """What a training run holds: the model, its step, the data, the
    optimizer state, the checkpoint manager, and the step to start at."""

    def __init__(self, args: argparse.Namespace, cfg=None):
        """``cfg`` (a caller's change of ``args.arch``'s config, such as a
        cut depth) replaces the registry's."""
        if args.production_mesh:
            raise NotImplementedError(
                "--production-mesh: the port trains on one card; a mesh "
                "of cards waits for the multi-card path")
        self.args = args
        cfg = cfg or get_config(args.arch)
        if args.reduced:
            cfg = reduce_cfg(cfg, layers=args.reduced_layers,
                             d_model=args.reduced_dmodel, vocab=2048)
        self.cfg = cfg
        self.model = build_model(cfg, device=args.device)
        self.tcfg = TrainConfig(
            opt=optlib.OptimizerConfig(
                peak_lr=args.lr, warmup_steps=min(20, args.steps // 5 + 1),
                total_steps=args.steps),
            grad_accum=args.grad_accum)
        self.step_fn = make_train_step(self.model, self.tcfg)
        self.data = SyntheticLM(
            DataConfig(vocab_size=min(cfg.vocab_size, 4096)), cfg,
            ShapeConfig("cli", args.seq, args.batch, "train"))
        self.opt_state = optlib.init(dict(self.model.net.named_parameters()))
        self.start = 0
        self.manager = None
        if args.ckpt_dir:
            self.manager = CheckpointManager(args.ckpt_dir)
            if args.resume == "auto":
                restored, self.start = elastic.resume(
                    self.manager, state_tree(self.model, self.opt_state,
                                             meta=True),
                    device=self.model.device)
                if restored is not None:
                    load_state(self.model, self.opt_state, restored)
                    print(f"resumed from step {self.start}")

    def save(self, step: int, blocking: bool = True) -> None:
        self.manager.save(step, state_tree(self.model, self.opt_state),
                          blocking)

    def train(self, on_step=None) -> None:
        """Steps ``start`` to ``--steps``, logging as the JAX launcher
        does, checkpointing every ``--ckpt-every`` updates and at the
        end; ``on_step(step, metrics)`` is called after each step."""
        args = self.args
        t0 = time.time()
        for step in range(self.start, args.steps):
            metrics = self.step_fn(self.opt_state, self.data.batch(step))
            if on_step is not None:
                on_step(step, metrics)
            if step % args.log_every == 0 or step == args.steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                per = (time.time() - t0) / (step - self.start + 1)
                print(f"step {step:5d} loss {m['loss']:.4f} "
                      f"ppl {m.get('perplexity', float('nan')):.1f} "
                      f"gnorm {m['grad_norm']:.3f} lr {m['lr']:.2e} "
                      f"({per:.2f}s/step)", flush=True)
            done = step + 1
            if self.manager and args.ckpt_every and done < args.steps and \
                    done % args.ckpt_every == 0:
                self.save(done, blocking=False)
        if self.manager:
            self.manager.wait()
            self.save(args.steps)


def main(argv=None) -> Run:
    run = Run(parse(argv))
    run.train()
    print("done")
    return run


if __name__ == "__main__":
    main()
