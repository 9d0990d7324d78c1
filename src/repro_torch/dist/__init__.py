"""Multi-array substrate of the serving spine.

  mesh      ArrayMesh: N logical FEATHER+ arrays, one sub-backend each,
            or one rank each of a process group (``device_mesh``)
  ranks     the process group's ranks: ``spawn`` starts them, the
            DeviceMesh of each mesh size, the host-staged collectives
  sharding  the logical-axis rules that map a model's parameters,
            optimizer state, batch and cache onto a mesh (specs, and
            ``torch.distributed.tensor`` placements), and the GEMM-rank
            axis policy ``core/program.shard_program`` uses
            (``GEMM_AXIS_RULES``, ``gemm_shard_axis``)
  elastic   resume from the latest checkpoint; the atomic serving
            snapshot a killed serve resumes from
  compression
            the int8 round trip of gradient compression, and the
            compressed data-parallel mean over a DeviceMesh

It imports only torch, numpy and the standard library.
"""

from repro_torch.dist.compression import compressed_dp_allreduce
from repro_torch.dist.mesh import ArrayMesh

__all__ = ["ArrayMesh", "compressed_dp_allreduce"]
