"""The port stands alone: every ``repro_torch`` module imports without JAX
and without the JAX package, and its entry points default to the card."""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

_IMPORT_ALL = """
import importlib, pathlib, sys
root = pathlib.Path(sys.argv[1])
names = sorted(
    ".".join(p.relative_to(root).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in (root / "repro_torch").rglob("*.py"))
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), leaked)
sys.exit(1 if leaked else 0)
"""


def test_port_imports_neither_jax_nor_the_reference():
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL, str(SRC)],
                       capture_output=True, text=True,
                       env={**os.environ, "PYTHONPATH": str(SRC)},
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    n_modules, leaked = r.stdout.split(" ", 1)
    assert int(n_modules) >= 42 and leaked.strip() == "[]"


_IMPORT_EXAMPLES = """
import importlib.util, pathlib, sys
paths = sorted(pathlib.Path(sys.argv[1]).glob("torch_*.py"))
for path in paths:
    spec = importlib.util.spec_from_file_location(path.stem, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(paths), leaked)
sys.exit(1 if leaked else 0)
"""


def test_examples_import_neither_jax_nor_the_reference():
    """``examples/torch_*.py`` stand on the port alone."""
    examples = SRC.parent / "examples"
    r = subprocess.run([sys.executable, "-c", _IMPORT_EXAMPLES,
                        str(examples)], capture_output=True, text=True,
                       env={**os.environ, "PYTHONPATH": str(SRC)},
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    n_examples, leaked = r.stdout.split(" ", 1)
    assert int(n_examples) == 4 and leaked.strip() == "[]"


def test_entry_points_default_to_the_card():
    """``device="cuda"`` is the default everywhere; with no GPU it raises
    (nothing falls back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.backends import (CudaBackend, InterpreterBackend,
                                      get_backend)
    from repro_torch.configs.feather import feather_config
    from repro_torch.core import FeatherMachine
    from repro_torch.runtime import ModelExecutable, ProgramCache, Scheduler
    cfg = feather_config(4, 16)
    with pytest.raises(RuntimeError, match="CUDA device"):
        CudaBackend(cfg)
    with pytest.raises(RuntimeError, match="CUDA device"):
        get_backend("cuda", cfg)
    with pytest.raises(RuntimeError, match="CUDA device"):
        InterpreterBackend(cfg)
    with pytest.raises(RuntimeError, match="CUDA device"):
        get_backend("interpreter", cfg)
    with pytest.raises(RuntimeError, match="CUDA device"):
        FeatherMachine(cfg)
    assert FeatherMachine(cfg, device="cpu").device.type == "cpu"
    cache = ProgramCache()
    pre = ModelExecutable.for_cell("gemma-7b", "prefill_tiny", cfg,
                                   cache=cache)
    dec = ModelExecutable.for_cell("gemma-7b", "decode_tiny", cfg,
                                   cache=cache)
    with pytest.raises(RuntimeError, match="CUDA device"):
        dec.make_backend("cuda")
    with pytest.raises(RuntimeError, match="CUDA device"):
        Scheduler(pre, dec)
    with pytest.raises(RuntimeError, match="CUDA device"):
        Scheduler(pre, dec, backend="interpreter")
    with pytest.raises(RuntimeError, match="CUDA device"):
        dec.run("interpreter")
    be = CudaBackend(cfg, device="cpu")
    assert be.device.type == "cpu" and be.name == "cuda"
    # the model zoo's serving path
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import build_model
    from repro_torch.serve import Engine
    mcfg = reduced(get_config("gemma-7b"))
    with pytest.raises(RuntimeError, match="CUDA device"):
        build_model(mcfg)
    with pytest.raises(RuntimeError, match="CUDA device"):
        Engine(build_model(mcfg, device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA device"):
        launch_serve.main(["--reduced"])
    assert build_model(mcfg, device="cpu").device.type == "cpu"


def test_device_environment_is_recorded(capsys):
    """What the test run saw: the device, CUDA, and the kernel toolchain."""
    import shutil
    from repro_torch.kernels import build
    try:
        nvcc = build.nvcc_path()
    except RuntimeError:
        nvcc = None
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    env = {"device": (torch.cuda.get_device_name(0)
                      if torch.cuda.is_available() else "cpu"),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "nvcc": nvcc, "triton": triton_version,
           "nvidia_smi": shutil.which("nvidia-smi")}
    print("device environment:", env)
    assert env["torch"] and (env["device"] != "cpu") == \
        torch.cuda.is_available()
