"""ExecuteMapping / ExecuteStreaming index semantics (paper §IV-D/E, Eq. 1).

Pure index math shared by the host-side mapper and the functional machine.

WO-S convention (IO-S is the transposed problem):

  stationary VN on PE(a_h, a_w):   r = r0 + a_w // G_r
                                   c = c0 + s_r*a_h + s_c*(a_w % G_c)
  streamed VN into column a_w at step t:
                                   j = r0 + a_w // G_r           (== r)
                                   m = m0 + s_m*t + (a_w % G_r) // G_c

Each PE computes dot(streamed VN(m, j), stationary VN(r, c)) and the result
accumulates into O[m, c]; reduction over r happens across (ExecuteMapping,
ExecuteStreaming) pairs and/or across PEs mapped to the same (m, c) —
functionally a scatter-add, architecturally BIRRD + the output buffer.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.isa import ExecuteMapping, ExecuteStreaming


@dataclasses.dataclass(frozen=True)
class TileIndices:
    """Dense index lattices describing one (E.Mapping, E.Streaming) pair."""
    r: np.ndarray      # [AW]        stationary VN row per PE column
    c: np.ndarray      # [AH, AW]    stationary VN col per PE
    m: np.ndarray      # [T, AW]     streamed VN row per column per step
    t_steps: int


def tile_indices(em: ExecuteMapping, es: ExecuteStreaming,
                 ah: int, aw: int) -> TileIndices:
    a_w = np.arange(aw)
    a_h = np.arange(ah)
    r = em.r0 + a_w // em.g_r                                  # [AW]
    c = em.c0 + em.s_r * a_h[:, None] + em.s_c * (a_w % em.g_c)[None, :]
    t = np.arange(es.t)
    m = es.m0 + es.s_m * t[:, None] + ((a_w % em.g_r) // em.g_c)[None, :]
    return TileIndices(r=r, c=c, m=m, t_steps=es.t)


def tile_macs(em: ExecuteMapping, es: ExecuteStreaming, ah: int, aw: int,
              wvn_rows: int, wvn_cols: int, ivn_cols: int) -> int:
    """Useful MACs of one tile (zero-padded lanes excluded)."""
    idx = tile_indices(em, es, ah, aw)
    valid_w = ((idx.r[None, :] >= 0) & (idx.r[None, :] < wvn_rows)
               & (idx.c >= 0) & (idx.c < wvn_cols))            # [AH, AW]
    valid_m = (idx.m >= 0) & (idx.m < ivn_cols)                # [T, AW]
    pe_active = valid_w[None, :, :] & valid_m[:, None, :]      # [T, AH, AW]
    return int(pe_active.sum()) * es.vn_size


def tile_unique_outputs(em: ExecuteMapping, es: ExecuteStreaming,
                        ah: int, aw: int) -> int:
    idx = tile_indices(em, es, ah, aw)
    pairs = set()
    for ti in range(idx.t_steps):
        for w in range(aw):
            for h in range(ah):
                pairs.add((int(idx.m[ti, w]), int(idx.c[h, w])))
    return len(pairs)
