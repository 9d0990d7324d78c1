"""End-to-end training driver on the PyTorch/CUDA port: a gemma-family
model (gemma-7b cut to 8 layers at d 512) for a few hundred steps, with
checkpointing and resume (the port's twin of ``examples/train_lm.py``).

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 200]
        [--ckpt-dir DIR] [--device cpu]

It calls ``repro_torch.launch.train`` with the JAX example's
arguments: batch 8 x 256 tokens, a checkpoint every 100 steps and
``--resume auto`` (so a second run with more ``--steps`` continues from
the last checkpoint; ``--steps`` also sets the learning-rate schedule's
warmup and length, as in the JAX launcher, so a run continued to more
steps is not the run it would have been straight).  ``--layers``,
``--d-model``, ``--batch``, ``--seq`` and ``--ckpt-every`` change the
size and the checkpoint period (the JAX example's by default; a smaller
size for a quick run on the CPU).  Attention runs the hand-written
``flash_attention`` and ``flash_attention_bwd`` kernels on the card;
``--device cpu`` runs their plain versions.  ``main(argv)`` returns the
loss of each step it ran, the step it started at and the
``launch.train.Run`` itself.
"""

import argparse
import os
import tempfile

from repro_torch.launch.train import Run, parse


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt_quick"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", default="8")
    ap.add_argument("--d-model", default="512")
    ap.add_argument("--batch", default="8")
    ap.add_argument("--seq", default="256")
    ap.add_argument("--ckpt-every", default="100")
    args = ap.parse_args(argv)
    run = Run(parse([
        "--arch", "gemma-7b", "--reduced",
        "--reduced-layers", args.layers, "--reduced-dmodel", args.d_model,
        "--steps", str(args.steps), "--batch", args.batch, "--seq", args.seq,
        "--ckpt-dir", args.ckpt_dir, "--ckpt-every", args.ckpt_every,
        "--resume", "auto", "--log-every", "20", "--device", args.device,
    ]))
    losses = []
    run.train(lambda step, metrics: losses.append(float(metrics["loss"])))
    print("done")
    return {"start": run.start, "losses": losses, "run": run}


if __name__ == "__main__":
    main()
