"""Build the CUDA kernels under ``csrc/`` into shared libraries.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` for Hopper
(``sm_90a``) into ``_build/lib<name>-<digest>.so``, a library with a
plain C interface that the kernel modules load through ``ctypes``.  The
digest covers the source and the flags, so an edited source rebuilds
and an unchanged one loads from the build directory.  :func:`build`
starts one ``nvcc`` per source, all at once, and waits for them.

Nothing here runs at import: the first launch of a kernel builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("nest_gemm", "fused_chain", "flash_decode", "flash_decode_proj",
           "flash_attention", "flash_attention_bwd", "mamba_scan",
           "mamba_scan_bwd", "empty")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
#: name -> {"seconds": build wall time (0.0 when loaded from disk),
#:          "log": nvcc's output (registers, shared memory, spills)}
BUILD_INFO: dict[str, dict] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=SOURCES) -> dict[str, dict]:
    """Compile every named source that is not built yet, one ``nvcc``
    each, all started together; raises with the compiler's output when
    one fails.  Returns :data:`BUILD_INFO` for the named sources."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = target(name)
        if out.exists():
            BUILD_INFO.setdefault(name, {"seconds": 0.0, "log": ""})
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
        BUILD_INFO[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {name: BUILD_INFO[name] for name in names}


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        out = target(name)
        if not out.exists():
            build((name,))
        lib = ctypes.CDLL(str(out))
        _LIBS[name] = lib
    return lib


def check_operand(t, name: str, ndim: int, dtype=None) -> None:
    """Raise unless ``t`` is a contiguous ``ndim``-D CUDA tensor of
    ``dtype`` (float32 by default) -- what the kernels take."""
    import torch
    dtype = torch.float32 if dtype is None else dtype
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def raise_on_error(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed with cudaError {err}")


def stream_handle() -> int:
    import torch
    return torch.cuda.current_stream().cuda_stream
