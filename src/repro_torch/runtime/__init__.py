"""MINISA model runtime: compiled-Program cache, whole-model executables
and a batched serving scheduler.

    configs -> model_gemms -> ProgramCache -> ModelExecutable
                                                  -> Scheduler -> Backend

  cache       ProgramCache -- one memoisation of mapper search ->
              Program lowering -> backend compile (hit/miss/byte stats,
              optional on-disk persistence, tagged with the backend so a
              JAX package cache file is never loaded)
  executable  ModelExecutable -- an (arch x shape) cell's GEMM stream
              lowered once into chained Programs and executed end-to-end
              on the CUDA backend against an einsum oracle of the stream
  scheduler   Scheduler -- continuous-batching serving loop over
              prefill/decode executables with per-request MINISA vs
              micro-instruction traffic and stall reporting
  autotune    autotune_segment -- measures the fused-segment frontier's
              top points through the backend's launch spans and keeps
              the winner in the cache's tuned tier, which executables
              build their fused segments from
"""

from repro_torch.runtime.autotune import (AutotuneReport,  # noqa: F401
                                          TunedGeometry, autotune_segment)
from repro_torch.runtime.cache import (CacheStats, ProgramCache,  # noqa: F401
                                       default_cache, reset_default_cache,
                                       segment_key)
from repro_torch.runtime.executable import (ACTIVATIONS, BatchPlan,  # noqa: F401
                                            BatchSegment, ModelExecutable,
                                            RunResult, Segment, Step,
                                            TINY_SHAPES, adapt,
                                            tensors_from_numpy)
from repro_torch.runtime.scheduler import (KVPool, PagedKV, Request,  # noqa: F401
                                           RequestReport, Scheduler,
                                           SchedulerReport)

__all__ = [
    "AutotuneReport", "TunedGeometry", "autotune_segment", "segment_key", "CacheStats", "ProgramCache", "default_cache",
    "reset_default_cache", "ACTIVATIONS", "BatchPlan", "BatchSegment",
    "ModelExecutable", "RunResult", "Segment", "Step", "TINY_SHAPES",
    "adapt", "tensors_from_numpy", "KVPool", "PagedKV", "Request",
    "RequestReport", "Scheduler", "SchedulerReport",
]
