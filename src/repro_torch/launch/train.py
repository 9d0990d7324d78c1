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
``done`` lines.

As the JAX launcher trains under a mesh of its devices, this one trains
under a mesh of the ranks of a process group when one is up with more
than one rank (``torchrun --nproc-per-node 4 -m repro_torch.launch.train
...``, or ranks started by ``dist.ranks.spawn``): ``make_host_mesh`` is
``(1, ranks)`` and ``--production-mesh`` the 16 x 16 mesh, which needs
256 ranks.  The parameters, the fp32 master weights and the moments are
DTensors placed by ``dist.sharding``'s rules (``train.trainer.place``),
each batch is sharded over the data axis, a resume distributes the
checkpoint onto the mesh's placements, and only rank 0 prints.  The
checkpoint holds the whole arrays, written by rank 0 alone, so a run
resumes on another mesh or in one process.  With no group (or a group
of one rank) the step runs on plain tensors, the host mesh's (1, 1)
step, exactly as before.

A checkpoint is labelled with the updates it holds: the step after
``n`` updates is saved as step ``n`` (every ``--ckpt-every`` updates and
at the end), and ``--resume auto`` continues with batch ``n``.  (The
JAX launcher labels its periodic saves one update early, so resuming
from one of them repeats a batch; its final save, which the CLI tests
resume from, is labelled as here.)
"""

from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs.base import ShapeConfig, reduced as reduce_cfg
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.dist import elastic, ranks
from repro_torch.launch.mesh import (device_mesh, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models.api import build_model
from repro_torch.train import optimizer as optlib
from repro_torch.train.trainer import (TrainConfig, load_state,
                                       make_train_step, place,
                                       state_placements, state_tree)


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


def _join_group(device: str) -> None:
    """Join the process group ``torchrun`` describes (``WORLD_SIZE`` > 1
    in the environment, no group up yet): gloo on the CPU, nccl when
    every rank has a card of its own, and ``dist.ranks.HOST_STAGED``
    when ranks share a card (nccl refuses them, and gloo crashes under
    the DTensors' collectives on the card)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world < 2 or dist.is_initialized():
        return
    backend = "gloo"
    if device != "cpu":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local % torch.cuda.device_count())
        backend = ("nccl" if torch.cuda.device_count() >= world
                   else ranks.HOST_STAGED)
        ranks.register_host_staged()
    dist.init_process_group(backend)


class Run:
    """What a training run holds: the model, its step, the data, the
    optimizer state, the checkpoint manager, the step to start at and,
    under a process group, the mesh."""

    def __init__(self, args: argparse.Namespace, cfg=None, mesh=None):
        """``cfg`` (a caller's change of ``args.arch``'s config, such as a
        cut depth) replaces the registry's; ``mesh`` (an ``AbstractMesh``
        of the group's size, such as (2, 2) for 4 ranks) replaces
        ``make_host_mesh``'s."""
        self.args = args
        world = dist.get_world_size() if dist.is_initialized() else 1
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.mesh = mesh
        if mesh is None and args.production_mesh:
            self.mesh = make_production_mesh()
            if world != self.mesh.size:
                raise NotImplementedError(
                    f"--production-mesh: the {self.mesh.axis_sizes} mesh "
                    f"needs a process group of {self.mesh.size} ranks; this "
                    f"one has {world}")
        elif mesh is None and world > 1:
            self.mesh = make_host_mesh(args.device)
        cfg = cfg or get_config(args.arch)
        if args.reduced:
            cfg = reduce_cfg(cfg, layers=args.reduced_layers,
                             d_model=args.reduced_dmodel, vocab=2048)
        self.cfg = cfg
        self.model = build_model(cfg, device=args.device)
        self.dmesh = None
        if self.mesh is not None:
            self.dmesh = device_mesh(self.mesh, self.model.device.type)
            place(self.model, self.dmesh)
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
                    placements=(None if self.dmesh is None else
                                state_placements(self.model, self.dmesh)),
                    device=self.model.device)
                if restored is not None:
                    load_state(self.model, self.opt_state, restored)
                    self.log(f"resumed from step {self.start}")

    def log(self, line: str) -> None:
        """Print ``line`` on rank 0 (every line in one process)."""
        if self.rank == 0:
            print(line, flush=True)

    def save(self, step: int, blocking: bool = True) -> None:
        """Checkpoint the state after ``step`` updates: on a mesh every
        rank gathers it whole and rank 0 alone writes it."""
        tree = state_tree(self.model, self.opt_state)
        if self.rank == 0:
            self.manager.save(step, tree, blocking)

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
                self.log(f"step {step:5d} loss {m['loss']:.4f} "
                         f"ppl {m.get('perplexity', float('nan')):.1f} "
                         f"gnorm {m['grad_norm']:.3f} lr {m['lr']:.2e} "
                         f"({per:.2f}s/step)")
            done = step + 1
            if self.manager and args.ckpt_every and done < args.steps and \
                    done % args.ckpt_every == 0:
                self.save(done, blocking=False)
        if self.manager:
            self.manager.wait()
            self.save(args.steps)


def main(argv=None) -> Run:
    args = parse(argv)
    _join_group(args.device)
    run = Run(args)
    run.train()
    run.log("done")
    return run


if __name__ == "__main__":
    main()
