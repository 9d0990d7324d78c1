"""repro_torch: the MINISA reproduction on PyTorch and CUDA (NVIDIA H100).

A second package beside the JAX/Pallas one (``repro``), with the same
sub-package and module names so each counterpart is easy to find.  It
imports ``torch`` and never ``jax``, and nothing of ``repro``.

Ported so far:

  configs   model and FEATHER+ configurations
  obs       span tracer, metrics registry, exporters
  core      MINISA ISA, layouts, perf model, Program IR, mapper, planner
  faults    fault plans and the injector the scheduler wires in
  kernels   hand-written CUDA kernels (``nest_gemm``, ``fused_chain``,
            ``flash_decode``, ``flash_decode_proj``, ``flash_attention``,
            ``mamba_scan``) and their plain PyTorch versions
  backends  ``CudaBackend`` (registry name ``"cuda"``) and
            ``InterpreterBackend`` (``"interpreter"``)
  runtime   ProgramCache, ModelExecutable, Scheduler
  dist      ArrayMesh, the GEMM axis policy, serving snapshots
  models    the model zoo's dense, vlm and ssm families as torch.nn
  serve     the batched serving Engine
  launch    ``python -m repro_torch.launch.serve``

Entry points run on the card by default (``device="cuda"``); the plain
versions run only for tensors on the CPU (``device="cpu"``).
"""
