"""Resume from the latest checkpoint, and serving-state snapshots: the
file a chaos-killed serve resumes from (counterpart of
``repro/dist/elastic.py``).

``resume`` restores the latest checkpoint of a
:class:`~repro_torch.ckpt.manager.CheckpointManager` into a target
tree's structure on one device: the JAX package's restore onto a new
mesh's shardings, on a single card.

``save_serving_snapshot``/``load_serving_snapshot`` persist a
:class:`~repro_torch.runtime.scheduler.Scheduler`'s request state --
pending + retired, the deterministic subset (in-flight requests replay
from their seeds) -- so a killed serve resumes and finishes with
checksums identical to the uninterrupted run.  The file is a plain
pickle of ``Scheduler.snapshot()``'s dict, the JAX package's format, so
either package's scheduler restores the other's snapshot.
"""

from __future__ import annotations

import os
import pickle
import tempfile


def resume(manager, abstract_tree, device=None):
    """(restored tree | None, start step): the latest checkpoint of
    ``manager`` restored into ``abstract_tree``'s structure (tensor
    leaves, ``meta`` ones too, give their shapes and dtypes) on
    ``device``; (None, 0) when the directory holds no checkpoint."""
    step = manager.latest_step()
    if step is None:
        return None, 0
    return manager.restore(step, abstract_tree, device=device), step


def save_serving_snapshot(path: str | os.PathLike, snapshot: dict) -> str:
    """Atomically persist a ``Scheduler.snapshot()`` dict (unique temp
    file in the destination directory, fsync, ``os.replace``) -- a kill
    mid-save leaves the previous snapshot intact, never a torn file."""
    path = os.fspath(path)
    dirname = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=dirname,
                               prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(snapshot, f, protocol=pickle.HIGHEST_PROTOCOL)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def load_serving_snapshot(path: str | os.PathLike) -> dict | None:
    """The persisted snapshot dict, or None when the file is missing or
    unreadable (a torn/corrupt snapshot means a cold start, not a
    crash)."""
    path = os.fspath(path)
    if not os.path.exists(path):
        return None
    try:
        with open(path, "rb") as f:
            snap = pickle.load(f)
        return snap if isinstance(snap, dict) else None
    except (pickle.PickleError, EOFError, AttributeError, ImportError,
            IndexError, OSError):
        return None
