"""Checkpointing: atomic, optionally asynchronous (counterpart of
``repro/ckpt/manager.py``, in its on-disk format).

Layout: ``<dir>/step_<N>/arrays.npz`` + ``manifest.json``, written to a
``.tmp`` directory and renamed into place, so a crashed writer never
corrupts the latest checkpoint.  The arrays' keys are the tree's paths
joined by ``/`` (dict keys, list indices), as the JAX package writes
them, so each package restores the other's checkpoints.  A tree is
nested dicts and lists whose leaves are tensors, numpy arrays or
numbers; a bf16 tensor is written as fp32 (numpy has no bf16; the
values are exact).  ``save_async`` copies the tree to host memory before
it returns (the training step may then change its buffers) and writes
on a background thread.

``restore`` reads a step into a target tree's structure, checking every
shape, and puts each array on a device (the target leaf's, or the one
given): the single-card counterpart of the JAX package's restore onto
new shardings.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.models.common import to_numpy


def _leaves(tree, prefix: str = ""):
    """(``/``-joined path, leaf) of every leaf of ``tree``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for key, val in items:
        yield from _leaves(val, f"{prefix}/{key}" if prefix else str(key))


def _owned(arr: np.ndarray) -> np.ndarray:
    """``arr``, or a copy where it is a view of memory it does not own.
    ``to_numpy`` of a CPU tensor (and so every leaf of a CPU
    ``state_tree``) shares the tensor's memory, which the optimizer
    changes in place while an asynchronous save writes it."""
    return arr if arr.flags.owndata else np.array(arr, copy=True)


def _flatten(tree) -> dict[str, np.ndarray]:
    """The host snapshot of ``tree``: every leaf a numpy array that owns
    its memory."""
    return {key: _owned(to_numpy(leaf) if isinstance(leaf, torch.Tensor)
                        else np.asarray(leaf))
            for key, leaf in _leaves(tree)}


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ----- write path -----
    def save(self, step: int, tree: Any, blocking: bool = True):
        flat = _flatten(tree)          # host snapshot (sync)
        if blocking:
            self._write(step, flat)
        else:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, flat), daemon=True)
            self._thread.start()

    def save_async(self, step: int, tree: Any):
        self.save(step, tree, blocking=False)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat: dict[str, np.ndarray]):
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "time": time.time(),
                       "n_arrays": len(flat)}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ----- read path -----
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target: Any, device=None) -> Any:
        """``target``'s structure filled from checkpoint ``step``; raises
        ``ValueError`` on a shape that differs.  A tensor leaf (any
        device, ``meta`` too) gives a tensor of its dtype on ``device``
        (default: its own, the CPU for ``meta``); any other leaf (an
        array, a number) gives a numpy array of its dtype."""
        path = os.path.join(self.dir, f"step_{step:08d}", "arrays.npz")
        with np.load(path) as data:
            def fill(node, key):
                if isinstance(node, dict):
                    return {k: fill(v, f"{key}/{k}" if key else str(k))
                            for k, v in node.items()}
                if isinstance(node, (list, tuple)):
                    return type(node)(fill(v, f"{key}/{i}" if key else str(i))
                                      for i, v in enumerate(node))
                arr = data[key]
                shape = tuple(np.shape(node))
                if tuple(arr.shape) != shape:
                    raise ValueError(f"ckpt shape mismatch at {key}: "
                                     f"{arr.shape} vs {shape}")
                if not isinstance(node, torch.Tensor):
                    return arr.astype(np.asarray(node).dtype)
                dev = device or (node.device if node.device.type != "meta"
                                 else "cpu")
                return torch.from_numpy(np.ascontiguousarray(arr)).to(
                    device=dev, dtype=node.dtype)
            return fill(target, "")
