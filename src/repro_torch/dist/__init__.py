"""Multi-array substrate of the serving spine.

  mesh      ArrayMesh: N logical FEATHER+ arrays, one sub-backend each
  sharding  the logical-axis rules that map a model's parameters,
            optimizer state, batch and cache onto a mesh (specs, and
            ``torch.distributed.tensor`` placements), and the GEMM-rank
            axis policy ``core/program.shard_program`` uses
            (``GEMM_AXIS_RULES``, ``gemm_shard_axis``)
  elastic   resume from the latest checkpoint; the atomic serving
            snapshot a killed serve resumes from
  compression
            the int8 round trip of gradient compression

It imports only torch, numpy and the standard library.
"""

from repro_torch.dist.mesh import ArrayMesh

__all__ = ["ArrayMesh"]
